"""Train an SDF net, extract its exact polyhedral complex, evaluate.

Counterpart of ``tropical/stanford/train.py``, with the same flags
(including the inverted ``store_false`` semantics of -c/-f: *passing* -c
disables the cache, *passing* -f disables the flat assumption) plus
``--device`` (default ``cuda``):

    python -m tropical_torch.stanford.train -e -m small -d sphere -s 1
    python -m tropical_torch.stanford.train -e -m medium -d sphere -s 1 -f
    python -m tropical_torch.stanford.train -c -m small -d sphere -s 1 --epochs 1

A cached checkpoint is looked for under ``tropical_torch/stanford/models/``
(where this CLI saves), then among the JAX package's committed ones under
``tropical/stanford/models/``.  On a miss, or with ``-c``, it builds the
dataset (procedural ``sphere``/``torus``, or a Stanford scan where its PLY
is present) and trains; it saves only without ``-c``, and never into the
JAX package's tree.  It then extracts with the flat path (or, with ``-f``,
the curved path: exact trilinear intersections, the gradient-descent rescue
and the strict filter), writes ``meshes_torch/<dataset>/our_mesh_*.ply``
and, with ``-e``, scores the mesh against a marching-cubes pseudo-GT.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

from tropical_torch import resolve_device, synchronize
from tropical_torch.utils.profiling import Phases

DIM = 3
CANVAS_SIZE = 1.2
BATCH_SIZE = 1000
# world scale divisor applied at export (the dataset's R; only R is needed
# on the cache-hit path, so the dataset is not built)
DATASET_R = 0.8

# where this CLI saves its checkpoints (listed in .gitignore), and the JAX
# package's committed ones, read only
MODELS_DIR = Path(__file__).resolve().parent / "models"
COMMITTED_MODELS_DIR = (Path(__file__).resolve().parents[2] / "tropical"
                        / "stanford" / "models")
OUT_ROOT = "meshes_torch"

# evaluation stages: "mc" (pseudo-GT and baseline meshes), "ray_trace",
# "chamfer" (CD + AD); timed with TROPICAL_PROFILE=1
PHASES = Phases()


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tropical_torch.stanford.train",
        description="Polyhedral complex derivation from piecewise trilinear "
                    "networks (PyTorch/CUDA)")
    parser.add_argument("-d", "--dataset", default="dragon",
                        choices=["bunny", "dragon", "happy", "armadillo",
                                 "drill", "lucy", "bunny_npy", "sphere",
                                 "torus"],
                        help="Stanford 3D scanning model name (or procedural)")
    parser.add_argument("-s", "--seed", default=45, type=int, help="Seed")
    parser.add_argument("-c", "--cache", default=True, action="store_false",
                        help="Cache the trained SDF?")
    parser.add_argument("-m", "--model_size", default="small",
                        choices=["small", "medium", "large"], help="Model size")
    parser.add_argument("-e", "--eval", default=False, action="store_true",
                        help="Run evaluation?")
    parser.add_argument("-f", "--force", default=True, action="store_false",
                        help="Force flat assumption to skip curve approximation.")
    parser.add_argument("--gt_res", default=None, type=int,
                        help="Pseudo-GT grid resolution (default 512; lower "
                             "for quick runs)")
    parser.add_argument("--epochs", default=None, type=int,
                        help="Training epochs (default 10, 6 for drill)")
    parser.add_argument("--extract_every", default=0, type=int,
                        help="Extract the polyhedral complex every N training "
                             "epochs (0 = only at the end), inside the one "
                             "training run; the reference also draws each "
                             "one, which waits for stanford/visualize.py")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    return parser.parse_args(argv)


def model_path_for(dataset: str, model_size: str, seed: int,
                   root: Path | None = None) -> str:
    """The checkpoint path under ``root`` (this CLI's ``MODELS_DIR`` by
    default)."""
    root = MODELS_DIR if root is None else root
    return str(root / dataset / f"{dataset}_sdf_{model_size}_{seed}.pth")


def cached_checkpoint(dataset: str, model_size: str, seed: int) -> str | None:
    """This CLI's own checkpoint, else the JAX package's committed one."""
    from tropical_torch.utils import checkpoint as ckpt

    for root in (MODELS_DIR, COMMITTED_MODELS_DIR):
        found = ckpt.find_checkpoint(
            model_path_for(dataset, model_size, seed, root))
        if found:
            return found
    return None


def extract_mesh(net, force: bool):
    """Timed extraction; returns torch tensors on the net's device."""
    import tropical_torch.extract.subdivide as sp

    t = time.time()
    polygons, vertices, faces_with_indices = sp.subpoly(
        net, DIM, CANVAS_SIZE, force=force)
    synchronize(net.device)
    our_t = time.time() - t
    print(f" take {our_t:.2f}")
    return polygons, vertices, faces_with_indices, our_t


def evaluate_against_grid_gt(net, our_mesh, our_t, dataset_R, gt_res,
                             out_dir, tag, resolutions=None):
    """CD/AD of the extracted mesh vs a marching-cubes pseudo-GT, and of MC
    baselines at lower resolutions, printed as the reference's table.

    The GT row scores the pseudo-GT against itself, which is identically
    zero, and is printed as zeros without computing it."""
    from tropical_torch.utils.chamfer import (angular_distance,
                                              chamfer_distance, get_rays,
                                              sample_surface_from_rays)
    from tropical_torch.utils.marching_cubes import run_marching_cubes

    dev = net.device
    rays_o, rays_d = get_rays(100000, device=dev)
    with PHASES("ray_trace"):
        our_samples, our_normals, our_mask = sample_surface_from_rays(
            rays_o, rays_d, our_mesh, return_normal=True)

    if resolutions is None:
        resolutions = [gt_res, 16, 24, 32, 40, 48, 56, 64, 128, 192, 224, 256]
        resolutions = [r for i, r in enumerate(resolutions)
                       if i == 0 or r < gt_res]

    def row(label, n_verts, cd, ad, t):
        print(f"{label}, {n_verts:5d}, {cd:0.6f}, {ad:4.1f}, {t:.2f}")

    def score(samples, normals, mask):
        with PHASES("chamfer"):
            cd = chamfer_distance(samples, gt_samples)
            common = mask & gt_mask
            ad, _ = angular_distance(normals[common], gt_normals[common])
        return cd, ad

    gt_samples = gt_normals = gt_mask = None
    print("Marching Cubes Results:")
    print("#samples, #vertices, CD, AD, time")
    for i in resolutions:
        t = time.time()
        with PHASES("mc"):
            mc_mesh = run_marching_cubes(net, i, CANVAS_SIZE, R=dataset_R)
        t = time.time() - t
        n_mc = mc_mesh.vertices.shape[0]
        with PHASES("ray_trace"):
            mc_samples, mc_normals, mc_mask = sample_surface_from_rays(
                rays_o, rays_d, mc_mesh, return_normal=True)
        if i == gt_res:
            if mc_samples.shape[0] == 0:
                # no ray hits on the pseudo-GT (an undertrained SDF): every
                # CD/AD of the table is undefined
                row("Ours", our_mesh.vertices.shape[0], 0, 0, our_t)
                row(f"{i:4d}", n_mc, 0, 0, t)
                continue
            gt_samples, gt_normals, gt_mask = mc_samples, mc_normals, mc_mask
            if our_samples.shape[0] == 0:
                row("Ours", our_mesh.vertices.shape[0], 0, 0, our_t)
            else:
                our_cd, our_ad = score(our_samples, our_normals, our_mask)
                row("Ours", our_mesh.vertices.shape[0], our_cd, our_ad, our_t)
            row(f"{i:4d}", n_mc, 0, 0, t)
            mc_mesh.export(os.path.join(out_dir, f"mc{i:03d}_mesh_{tag}.ply"))
            continue

        if gt_samples is None or mc_samples.shape[0] == 0:
            row(f"{i:4d}", n_mc, 0, 0, t)
            continue
        mc_cd, mc_ad = score(mc_samples, mc_normals, mc_mask)
        row(f"{i:4d}", n_mc, mc_cd, mc_ad, t)
        mc_mesh.export(os.path.join(out_dir, f"mc{i:03d}_mesh_{tag}.ply"))
    print()


def train_net(net, args, device) -> None:
    """Build the dataset and train ``net`` in place; save unless -c."""
    import numpy as np

    from tropical_torch.stanford.dataset import StanfordDataset
    from tropical_torch.stanford.training import train
    from tropical_torch.utils import checkpoint as ckpt

    epochs = args.epochs
    if epochs is None:
        epochs = 6 if args.dataset == "drill" else 10
    dataset = StanfordDataset(args.dataset,
                              rng=np.random.default_rng(args.seed),
                              device=device)

    def mid_train_extract(done: int) -> None:
        if done % args.extract_every == 0:
            print(f"[epoch {done}] intermediate extraction:", end="")
            extract_mesh(net, args.force)

    train(net, dataset, epochs, BATCH_SIZE,
          epoch_callback=mid_train_extract if args.extract_every > 0 else None)
    print("Finished training.", flush=True)
    if args.cache:
        saved = ckpt.save_params(
            model_path_for(args.dataset, args.model_size, args.seed),
            net.params_to_numpy())
        print(f"Saved {saved}")


def main(argv=None):
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.ply import Mesh

    args = parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    seed = args.seed

    net = net_for_size(args.model_size, args.dataset, seed, device=device)
    found = (cached_checkpoint(args.dataset, args.model_size, seed)
             if args.cache else None)
    if found:
        ckpt.load_into(net, found)
        print(f"The pretrained model loaded from {found}")
    else:
        if args.cache:
            print("warning: cannot find a pretrained model for seed "
                  f"({seed})! Training from scratch.", flush=True)
        train_net(net, args, device)

    polygons, vertices, faces_with_indices, our_t = extract_mesh(net, args.force)

    our_mesh = Mesh(vertices.cpu().numpy() / DATASET_R,
                    faces_with_indices.cpu().numpy())
    print(f"Ours: {our_mesh.vertices.shape}/{our_mesh.faces.shape}")

    if our_mesh.vertices.shape[0] == 0:
        print("warning: empty extraction (the SDF has no zero level set in "
              "the canvas — likely undertrained); skipping export/eval.")
        return 2

    out_dir = os.path.join(OUT_ROOT, args.dataset)
    os.makedirs(out_dir, exist_ok=True)
    tag = f"{args.model_size}_{seed}"
    our_mesh.export(os.path.join(out_dir, f"our_mesh_{tag}.ply"))

    if not args.eval:
        return 0

    gt_res = args.gt_res or 512
    evaluate_against_grid_gt(net, our_mesh, our_t, DATASET_R, gt_res,
                             out_dir, tag)
    PHASES.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Standalone evaluation of a cached SDF and its extracted mesh.

Counterpart of ``tropical/stanford/evaluate.py``, with the same flags
(-d/-s/-m/-t/--gt_res) plus ``--device`` (default ``cuda``):

    python -m tropical_torch.stanford.evaluate -d sphere -m small -s 1 -t mtet
    python -m tropical_torch.stanford.evaluate -d sphere -m small -s 1 -t mc \\
        --gt_res 128

It loads the checkpoint the training CLI would (its own, else the JAX
package's committed one) and the mesh that CLI wrote,
``meshes_torch/<dataset>/our_mesh_<size>_<seed>.ply``; counts the mesh's
vertices on the hash grid's marks; and scores the mesh against a
marching-cubes pseudo-GT at ``--gt_res`` (default 256 for small, else 512),
beside marching-cubes (``-t mc``) or marching-tetrahedra (``-t mtet``)
baselines at the lower resolutions of the ladder.  Baseline meshes are
written beside the mesh.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from tropical_torch import resolve_device
from tropical_torch.stanford.train import (DATASET_R, OUT_ROOT, PHASES,
                                           cached_checkpoint,
                                           evaluate_against_grid_gt,
                                           model_path_for)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m tropical_torch.stanford.evaluate",
        description="Polyhedral complex derivation from piecewise trilinear "
                    "networks (PyTorch/CUDA)")
    parser.add_argument("-d", "--dataset", default="dragon",
                        choices=["bunny", "dragon", "happy", "armadillo",
                                 "drill", "lucy", "sphere", "torus"])
    parser.add_argument("-s", "--seed", default=45, type=int, help="Seed")
    parser.add_argument("-m", "--model_size", default="small",
                        choices=["small", "medium", "large"], help="Model size")
    parser.add_argument("-t", "--method", default="mc",
                        choices=["mc", "mtet"], help="Mesh extraction method")
    parser.add_argument("--gt_res", default=None, type=int,
                        help="Pseudo-GT grid resolution (default 256 for "
                             "small, else 512)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda)")
    return parser.parse_args(argv)


def count_vertices_near_values(vertices, values, threshold=1e-4) -> int:
    """Vertices with at least one coordinate within ``threshold`` of one of
    ``values`` (numpy arrays)."""
    near = np.zeros(len(vertices), bool)
    for v in np.asarray(values).ravel():
        near |= (np.abs(vertices - v) < threshold).any(-1)
    return int(near.sum())


def resolutions_for(method: str, model_size: str, gt_res: int) -> list:
    """The pseudo-GT resolution, then the baselines' below it."""
    if method == "mc":
        ladder = [gt_res, 16, 24, 32, 40, 48, 56, 64, 128, 192, 224]
    else:
        ladder = [gt_res, 16, 32, 48, 64, 96]
        if model_size == "large":
            ladder += [128, 192]
    return [ladder[0]] + [r for r in ladder[1:] if r < gt_res]


def main(argv=None):
    from tropical_torch.stanford.model import net_for_size
    from tropical_torch.utils import checkpoint as ckpt
    from tropical_torch.utils.ply import read_ply

    args = parse_args(argv)
    print(args)
    device = resolve_device(args.device)
    seed = args.seed

    found = cached_checkpoint(args.dataset, args.model_size, seed)
    out_dir = os.path.join(OUT_ROOT, args.dataset)
    mesh_path = os.path.join(out_dir, f"our_mesh_{args.model_size}_{seed}.ply")
    if not found:
        print("Model path is not found: "
              f"{model_path_for(args.dataset, args.model_size, seed)}")
        return 1
    if not os.path.isfile(mesh_path):
        print(f"Mesh path is not found: {mesh_path}")
        return 1

    net = net_for_size(args.model_size, args.dataset, seed, device=device)
    ckpt.load_into(net, found)
    print(f"The pretrained model is loaded from {found}")
    our_mesh = read_ply(mesh_path)
    print(f"The mesh is loaded from {mesh_path}")
    print(f"Ours: {our_mesh.vertices.shape}/{our_mesh.faces.shape}")

    # on-grid vertex statistics, in world coordinates
    marks_world = net.preprocess_inverse(net.marks).cpu().numpy() / DATASET_R
    count = count_vertices_near_values(our_mesh.vertices, marks_world)
    print(f"Number of vertices near the grid marks: {count} "
          f"({count / our_mesh.vertices.shape[0]:.4f})")

    gt_res = args.gt_res or (256 if args.model_size == "small" else 512)
    evaluate_against_grid_gt(
        net, our_mesh, -1.0, DATASET_R, gt_res, out_dir,
        f"{args.model_size}_{seed}",
        resolutions=resolutions_for(args.method, args.model_size, gt_res),
        method=args.method)
    PHASES.report()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""The "Ours" row of the port's own mesh against the JAX mesh's, on the CPU.

``chip_smoke.py`` runs the ``evaluate`` CLI on the card on the mesh that
the port's training CLI wrote, and holds its table to the JAX CLI's golden
(``tests/golden/sphere_small_evaluate_1.json``), which scored the committed
JAX mesh.  This test measures the tolerances that "Ours" row needs: the
port's mesh differs from the JAX mesh by f32 rounding and in a few fan
diagonals (``test_torch_eval.py``).
"""

import io
import shutil
from contextlib import redirect_stdout

from evaluate_table import parse_table
from test_torch_evaluate import MESH, few_rays  # noqa: F401
from test_torch_eval import _rows


def test_ours_row_of_the_port_mesh_matches_the_jax_mesh(few_rays, monkeypatch,
                                                        tmp_path):
    """The port's own mesh (its training CLI on the CPU) scores as the JAX
    mesh does: the on-grid count and vertex count equal, "Ours" CD within
    1e-6 and AD within 0.1."""
    from tropical_torch.stanford import evaluate as teval
    from tropical_torch.stanford import train as ttrain

    monkeypatch.chdir(tmp_path)
    assert ttrain.main(["-m", "small", "-d", "sphere", "-s", "1",
                        "--device", "cpu"]) == 0
    argv = ["-d", "sphere", "-m", "small", "-s", "1", "-t", "mtet",
            "--gt_res", "32", "--device", "cpu"]
    outs = []
    for mesh in (None, MESH):
        if mesh:
            shutil.copy(mesh, "meshes_torch/sphere/our_mesh_small_1.ply")
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert teval.main(argv) == 0
        outs.append(buf.getvalue())
    grids = [parse_table(t) for t in outs]
    assert grids[0]["on_grid"] == grids[1]["on_grid"] == 10138
    assert grids[0]["on_grid_frac"] == grids[1]["on_grid_frac"]
    ours = [_rows(t)[0] for t in outs]
    assert ours[0][:2] == ours[1][:2] == ("Ours", "10138")
    assert abs(float(ours[0][2]) - float(ours[1][2])) <= 1e-6
    assert abs(float(ours[0][3]) - float(ours[1][3])) <= 0.1

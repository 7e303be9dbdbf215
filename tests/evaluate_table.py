"""The table an ``evaluate`` run prints, parsed: the JAX package's CLI and
the port's print the same lines.  Used by the golden writer
(``scripts/evaluate_golden.py``), ``chip_smoke.py`` and the tests; it
imports nothing but ``re``."""

import re


def parse_table(text: str) -> dict:
    """The on-grid line (None without one: ``evaluate_against_grid_gt``
    alone prints none) and the table rows of one evaluate run's output."""
    grid = re.search(r"^Number of vertices near the grid marks: (\d+) "
                     r"\(([\d.]+)\)$", text, re.M)
    rows = re.findall(r"^(Ours|\s*\d+), +(\d+), ([\d.]+), +([\d.]+), "
                      r"(-?[\d.]+)$", text, re.M)
    if not rows:
        raise ValueError("no table in the evaluate output")
    return {"on_grid": int(grid.group(1)) if grid else None,
            "on_grid_frac": float(grid.group(2)) if grid else None,
            "rows": [{"label": r[0].strip(), "vertices": int(r[1]),
                      "cd": float(r[2]), "ad": float(r[3]),
                      "s": float(r[4])} for r in rows]}

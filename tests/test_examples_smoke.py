"""Execute every example PROGRAM end-to-end on the CPU backend.

The reference treats its 12 example programs as the acceptance workloads
(SURVEY.md §2.8); `examples/acceptance.py` runs the on-device battery, but
until this gate nothing executed the programs themselves (argument
parsing, file outputs, the `_common.render_stl` plumbing) in the CPU-only
CI configuration — a broken example would only surface on hardware.

Each program runs in-process (one shared JAX context keeps this fast)
via runpy with a patched argv, in a tmp cwd, at a tiny resolution.
"""
import runpy
import sys
from pathlib import Path

import pytest

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"

# program -> (argv tail, expected output files in cwd)
PROGRAMS = {
    "npt_flange.py": (["--cpu", "--resdiv", "48"], ["nptflange.stl"]),
    "fibonacci_showerhead.py": (["--cpu", "--resdiv", "48"], ["showerhead.stl", "thread.png"]),
    "bolt.py": (["--cpu", "--resdiv", "48"], ["bolt.stl"]),
    "knurled_cylinder.py": (["--cpu", "--resdiv", "48"], ["knurled-cyl.stl"]),
    "simple_knurled.py": (["--cpu", "--resdiv", "48"], ["simple-knurled.stl"]),
    # the gasket is a thin extrusion: resdiv 48 of its (wide) diagonal
    # leaves zero whole voxels across z and the STL writer (correctly)
    # refuses the empty mesh — render with enough z divisions instead
    "gasket.py": (["--cpu", "--resdiv", "200"], ["gasket.stl", "gasket2D.png"]),
    "plantpot.py": (["--cpu", "--resdiv", "48"], ["plantpot.stl", "plantpot2D.png"]),
    "metric_spacers.py": (
        ["--cpu", "--resdiv", "48", "--spacers", "M3x5"],
        ["spacer_M3x5.stl", "M3x5.png"],
    ),
    "image.py": ([], ["image-example.png"]),
    "image_text.py": ([], ["image-text.png"]),
    "ui_mandala.py": (["--cpu", "--resdiv", "48"], ["mandala.stl"]),
    "ui_text.py": (["--cpu", "--resdiv", "48"], []),  # output name checked below
    "ui_geb.py": (["--cpu", "--resdiv", "48"], ["geb.stl"]),
    "template.py": (["--cpu", "--resdiv", "48"], ["template-part.stl"]),
}


@pytest.fixture(autouse=True)
def _examples_on_path(monkeypatch):
    monkeypatch.syspath_prepend(str(EXAMPLES))


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_example_program_runs(program, tmp_path, monkeypatch, capsys):
    argv_tail, expected = PROGRAMS[program]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", [program] + argv_tail)
    runpy.run_path(str(EXAMPLES / program), run_name="__main__")
    out = capsys.readouterr().out
    assert "finished" in out or "wrote" in out, out
    for fname in expected:
        f = tmp_path / fname
        assert f.exists() and f.stat().st_size > 0, f"missing output {fname}"
    stls = list(tmp_path.glob("*.stl"))
    if any(e.endswith(".stl") for e in expected) or program == "ui_text.py":
        assert stls, "no STL produced"
        # every STL must parse back and carry at least one triangle
        from gsdf_tpu.render.stl import read_binary_stl

        for s in stls:
            with open(s, "rb") as f:
                tris = read_binary_stl(f, validate=True)
            assert len(tris) > 0, f"empty STL {s.name}"

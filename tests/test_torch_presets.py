"""The port's presets (``nans_clip_tpu_torch/run_scripts/*.sh``) and notebook
(``nans_clip_tpu_torch/notebooks/NanS-CLIP-Retrieval.ipynb``) on the CPU.

A stand-in ``python`` at the head of ``PATH`` records the argv each preset
runs and exits. Each of the nine port presets must run the argv of the
repository's JAX preset (``run_scripts/``) with its module renamed into the
port, the same arguments and defaults (the ``"${@:2}"`` pass-through
included), and every flag must parse in the port module's own parser.
Each ``!python -m`` line of the notebook must name a port module whose
parser takes its flags."""

import json
import os
import shlex
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PRESETS = ROOT / "run_scripts"
PORT_PRESETS = ROOT / "nans_clip_tpu_torch" / "run_scripts"
NOTEBOOK = ROOT / "nans_clip_tpu_torch" / "notebooks" / "NanS-CLIP-Retrieval.ipynb"
PRESETS = sorted(p.name for p in JAX_PRESETS.glob("*.sh"))


def _recorded(script: Path, args, tmp_path) -> list:
    """The argv lists ``script`` hands to ``python``, run with ``args``."""
    bindir = tmp_path / "bin"
    bindir.mkdir(exist_ok=True)
    log = tmp_path / "argv.jsonl"
    fake = bindir / "python"
    fake.write_text(f"#!{sys.executable}\nimport json, sys\n"
                    f"open({str(log)!r}, 'a').write(json.dumps(sys.argv[1:]) + '\\n')\n")
    fake.chmod(0o755)
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}")
    proc = subprocess.run(["bash", str(script), *args], env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stderr
    lines = log.read_text().splitlines()
    log.unlink()
    return [json.loads(ln) for ln in lines]


def _parse(module: str, argv: list):
    """``argv`` through the port module's parser (a SystemExit fails)."""
    import importlib

    if module == "nans_clip_tpu_torch.training.main":
        from nans_clip_tpu_torch.training.params import parse_args
        return parse_args(argv)
    if module == "nans_clip_tpu_torch.eval.evaluation":   # three positional paths
        assert len(argv) == 3 and not any(a.startswith("-") for a in argv), argv
        return argv
    if module == "nans_clip_tpu_torch.preprocess.build_dataset":
        from nans_clip_tpu_torch.preprocess import build_dataset
        seen = []
        real = build_dataset.build_split
        build_dataset.build_split = lambda d, s, o=None: seen.append((d, s)) or {}
        try:
            build_dataset.main(argv)
        finally:
            build_dataset.build_split = real
        return seen
    return importlib.import_module(module).parse_args(argv)


@pytest.mark.parametrize("name", PRESETS)
def test_preset_runs_the_jax_argv_in_the_port(name, tmp_path):
    assert (PORT_PRESETS / name).is_file() and len(PRESETS) == 9
    args = {"zeroshot_eval.sh": ["./dp", "cifar-10", "ViT-L-14", "RoBERTa-wwm-ext-large-chinese"],
            "e2e_drill.sh": ["tiny", str(tmp_path / "work"), str(tmp_path / "d.json")]}.get(
        name, ["./dp", "--seed", "7"])
    for given in (args, args[:1]):
        want = _recorded(JAX_PRESETS / name, given, tmp_path)
        got = _recorded(PORT_PRESETS / name, given, tmp_path)
        assert len(want) == len(got) == 1
        assert want[0][:2] == ["-m", want[0][1]] and want[0][1].startswith("nans_clip_tpu.")
        renamed = ["-m", want[0][1].replace("nans_clip_tpu.", "nans_clip_tpu_torch.", 1)]
        assert got[0] == renamed + want[0][2:]
        _parse(got[0][1], got[0][2:])
    if name == "e2e_drill.sh":
        assert got[0][-2:] == ["--platform", "cpu"]
    if name.endswith("_flashattn.sh"):
        from nans_clip_tpu_torch.ops import gates
        assert "fused" in gates.IMPLS and got[0][got[0].index("--attn-impl") + 1] == "fused"


def _commands(source: str) -> list:
    """The ``!python -m`` commands of a cell, continuation lines joined."""
    out = []
    for line in source.replace("\\\n", " ").splitlines():
        if line.startswith("!python -m "):
            out.append(shlex.split(line[len("!python -m "):]))
    return out


def test_notebook_commands_parse_in_the_port():
    nb = json.loads(NOTEBOOK.read_text(encoding="utf-8"))
    code = [c for c in nb["cells"] if c["cell_type"] == "code"]
    assert len(code) == 6 and all(not c["outputs"] and c["execution_count"] is None for c in code)
    assert "datapath" in "".join(nb["cells"][0]["source"])   # says what it expects
    commands = [cmd for c in code for cmd in _commands("".join(c["source"]))]
    assert len(commands) == 8
    for cmd in commands:
        assert cmd[0].startswith("nans_clip_tpu_torch."), cmd
        _parse(cmd[0], cmd[1:])
    text = "".join("".join(c["source"]) for c in code)
    assert "nans_clip_tpu." not in text and "import jax" not in text
    assert "compile_tower(model, 'image', 64)" in text

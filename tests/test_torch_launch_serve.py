"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the CPU:
a packed-weight, paged-APack-KV run prints the JAX CLI's summary lines, the
materialize oracle and a dense int8 cache serve, and every flag the port does not serve yet, like the JAX CLI's default
checkpoint round trip, raises ``NotImplementedError`` naming its ROADMAP
item instead of falling back."""
import pathlib
import subprocess
import sys

import pytest

from repro_torch.launch import serve

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASE = ["--arch", "qwen3-1.7b", "--smoke", "--kv", "apack-int8",
        "--device", "cpu"]


def test_cli_serves_from_packed_weights():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", *BASE,
           "--weights", "apack-int8", "--weight-min-size", "1024",
           "--requests", "2", "--prompt-len", "8", "--max-new", "3",
           "--max-batch", "2", "--kv-page-size", "4"]
    out = subprocess.run(cmd, env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    store = [ln for ln in lines if ln.startswith("packed weight store: 7 "
                                                 "tensors")]
    assert len(store) == 1, out.stdout
    assert "per-step weight reads x" in store[0]
    assert any(ln.startswith("packed the weights in") for ln in lines)
    assert any("'completed': 2" in ln and "tok/s on cpu" in ln
               for ln in lines), out.stdout
    assert any(ln.startswith("paged KV traffic:") for ln in lines)


@pytest.mark.parametrize("extra,path", [
    (["--kv-materialize"], "decode path: materialize;"),
    (["--kv", "int8"], "decode path: dense int8 KV cache"),
])
def test_cli_serves_the_oracle_and_dense_cache(extra, path, capsys):
    """``--kv-materialize`` serves the paged cache through the materialize
    oracle; ``--kv int8`` a dense int8 cache (no paged-KV summary)."""
    serve.main(BASE + ["--no-compress", "--requests", "3", "--prompt-len",
                       "8", "--max-new", "4", "--max-batch", "2",
                       "--kv-page-size", "4"] + extra)
    lines = capsys.readouterr().out.splitlines()
    assert any("'completed': 3" in ln and "tok/s on cpu" in ln
               for ln in lines), lines
    assert any(ln.startswith(path) for ln in lines), lines
    assert any(ln.startswith("paged KV traffic:") for ln in lines) \
        == ("--kv-materialize" in extra)


@pytest.mark.parametrize("extra", [
    ["--no-compress", "--mesh", "2x1"],
    ["--no-compress", "--scheduler", "async"],
    ["--weights", "apack-int8", "--kv-refresh"],
    ["--weights", "apack-int8", "--kv-refresh-every", "4"],
    ["--weights", "apack-int8", "--kv-pressure", "--slot-deadline", "6"],
    ["--weights", "apack-int8", "--window-size", "8"],
])
def test_cli_refuses_unported_flags(extra):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(BASE + extra)


def test_cli_refuses_the_checkpoint_round_trip():
    """Neither --weights nor --no-compress: the JAX CLI's default
    compress/decompress round trip, which the port does not have yet."""
    with pytest.raises(NotImplementedError,
                       match="round trip.*ROADMAP open items 1.1, 1.2"):
        serve.main(BASE)

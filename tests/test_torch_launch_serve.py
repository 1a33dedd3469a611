"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the CPU:
the default weight path (the checkpoint-style round trip) and a
packed-weight run, both on the paged APack KV cache, print the JAX CLI's
summary lines; the materialize oracle and a dense int8 cache serve; every
flag the port does not serve yet raises ``NotImplementedError`` naming its
ROADMAP item, and without ``--device cpu`` the CLI asks for the card and
raises where there is none, instead of falling back."""
import dataclasses
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.serve import compress_params

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


def test_cli_default_device_needs_cuda():
    """No --device: the CLI runs on the card, and on a machine without one
    it refuses to start rather than fall back to the CPU (here on the
    default weight path, neither --weights nor --no-compress)."""
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a machine without CUDA")
    no_device = BASE[:BASE.index("--device")]
    with pytest.raises(RuntimeError, match="CUDA requested"):
        serve.main(no_device)


def test_cli_default_path_runs_the_weight_round_trip(capsys):
    """Neither --weights nor --no-compress: the JAX CLI's default, the
    checkpoint-style round trip.  The compression line prints with the
    MB and ratio of ``compress_params`` on the same params (the CLI's seed-0
    draw), and the requests complete on the round-tripped weights."""
    serve.main(BASE + ["--requests", "2", "--prompt-len", "8", "--max-new",
                       "3", "--max-batch", "2", "--kv-page-size", "4"])
    lines = capsys.readouterr().out.splitlines()
    cfg = dataclasses.replace(configs.get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    params = M.init_params(cfg, torch.Generator("cpu").manual_seed(0), "cpu")
    cp = compress_params(params)
    line = [ln for ln in lines if ln.startswith("APack weight compression:")]
    assert len(line) == 1, lines
    assert line[0].startswith(
        f"APack weight compression: {cp.original_bytes/1e6:.1f} MB -> "
        f"{cp.compressed_bytes/1e6:.1f} MB ({cp.ratio:.2f}x, ")
    assert len(cp.containers) == 4 and cp.ratio > 1
    assert any("'completed': 2" in ln and "tok/s on cpu" in ln
               for ln in lines), lines
    assert any(ln.startswith("paged KV traffic:") for ln in lines)
    assert not any(ln.startswith("packed") for ln in lines)

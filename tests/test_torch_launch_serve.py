"""The port's serving CLI, ``python -m repro_torch.launch.serve``, on the CPU:
the default weight path (the checkpoint-style round trip) and a
packed-weight run, both on the paged APack KV cache, print the JAX CLI's
summary lines; the materialize oracle and a dense int8 cache serve;
``--mesh`` serves on a one-device mesh of the shape asked; ``--scheduler
async``,
``--prefill-chunk``, ``--slo-ms``, ``--kv-refresh`` and ``--kv-pressure``
serve and print their report lines; and without ``--device cpu`` the CLI
asks for the card and raises where there is none, instead of falling
back."""
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
    ["--weights", "apack-int8", "--weight-min-size", "1024", "--mesh",
     "1x1"],
])
def test_cli_refuses_unported_flags(extra, capsys):
    """``--mesh`` is served (every flag of the JAX CLI is now): the CLI
    prints the mesh with its devices and serves every request, from dense
    and from packed weights."""
    serve.main(BASE + extra + ["--requests", "3", "--prompt-len", "8",
                               "--max-new", "3", "--max-batch", "2",
                               "--kv-page-size", "4"])
    lines = capsys.readouterr().out.splitlines()
    shape = extra[-1].split("x")
    assert any(ln.startswith(f"serving mesh: {{'data': {shape[0]}, 'model': "
                             f"{shape[1]}}} over ") for ln in lines), lines
    assert any("'completed': 3" in ln and "tok/s on cpu" in ln
               for ln in lines), lines


@pytest.mark.parametrize("extra,want", [
    (["--no-compress", "--scheduler", "async"],
     "latency (async scheduler, n=3)"),
    (["--no-compress", "--prefill-chunk", "8"], "'completed': 3"),
    (["--no-compress", "--slo-ms", "100"], "latency (sync scheduler, n=3)"),
    (["--kv-refresh", "--scheduler", "async", "--prefill-chunk", "3"],
     "latency (async scheduler, n=3)"),
])
def test_cli_serves_async_chunked_and_slo(extra, want, capsys):
    """``--scheduler async`` (also with ``--kv-refresh`` and the default
    weight round trip), ``--prefill-chunk`` and ``--slo-ms`` serve every
    request and print the JAX CLI's lines, the latency line naming the
    scheduler."""
    serve.main(BASE + ["--requests", "3", "--prompt-len", "8",
                       "--max-new", "4", "--max-batch", "2",
                       "--kv-page-size", "4"] + extra)
    out = capsys.readouterr().out
    assert want in out, out
    assert "'completed': 3" in out, out


@pytest.mark.parametrize("extra,want", [
    (["--kv-refresh", "--kv-refresh-every", "4",
      "--kv-refresh-threshold", "0.2", "--kv-repack-budget", "8"],
     "table refresh: on; generation="),
    (["--kv-pages", "24", "--kv-pressure", "--slot-deadline", "6"],
     "spill tier: "),
])
def test_cli_serves_refresh_and_pressure(extra, want, capsys):
    """``--kv-refresh`` refreshes tables and re-packs pages (generation >=
    1); a pool of 24 pages under ``--kv-pressure --slot-deadline 6`` spills
    pages and reads every one back, with nothing quarantined or failed.
    Both print the JAX CLI's report lines."""
    serve.main(BASE + ["--no-compress", "--requests", "6", "--prompt-len",
                       "8", "--max-new", "8", "--max-batch", "3",
                       "--kv-page-size", "4"] + extra)
    lines = capsys.readouterr().out.splitlines()
    assert any("'completed': 6" in ln for ln in lines), lines
    line = [ln for ln in lines if ln.startswith(want)]
    assert len(line) == 1, lines
    if "refresh" in want:
        gen = int(line[0].split("generation=")[1].split()[0])
        assert gen >= 1 and "repacked=0 pages" not in line[0]
    else:
        spilled = int(line[0].split("spill tier: ")[1].split()[0])
        ahead = int(line[0].split("readahead ")[1].split()[0])
        assert spilled > 0 and ahead == spilled
        assert "quarantined=0" in line[0] and "failed=0" in line[0]


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
    cp = compress_params(cfg, params)
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

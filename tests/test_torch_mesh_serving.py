"""The port's engine serving on a mesh (``mesh=make_debug_mesh(...,
device="cpu")``: every shard on the CPU, one controller) against its
single-device engine and the JAX package's single-device engine, on the
workload of ``tests/test_mesh_serving.py:274-302``: ``max_batch=8``,
``max_len=32``, 8 requests of 9 tokens, 8 new each.

- 8x1 on qwen3-1.7b SMOKE: greedy tokens equal both single-device
  engines'; mid-serve every request's pages lie in its slot's data-shard
  range; ``kv_shard_free``/``kv_shard_reserved`` per shard; a steady step
  reads back one ``.cpu()`` (the tokens) beside its seal batches' pulls;
  after the drain every shard's free list is whole.
- 4x2 (KV heads over the model axis in kernel 3) on qwen3 SMOKE and
  ``hetero-serve-smoke``: tokens equal.
- 8x1 on ``hetero-serve-smoke`` with slot 2 preempted with spill and slot
  5 without after 3 steps: tokens equal.
- 1x2 from packed weights (tile 32, so that every site K-splits): the
  teacher-forced logits within the parity tests' 0.05 of the
  single-device packed engine's.
- ``--mesh 2x2 --device cpu`` through the CLI.

The CPU's f32 GEMM of one row can sum in another order than of eight
(``modules.matmul(x[:1], w)`` differs from ``matmul(x, w)[:1]`` in the
last bit at the SMOKE head, [1, 64] @ [64, 512]); an 8x1 shard decodes one
row, and its tokens still equal the 8-row engines' here."""
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from repro import configs as jconfigs
from repro.models import model as JM
from repro.serve import Request as JRequest, ServeEngine as JEngine
from repro_torch.configs import get_smoke_config
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine

ROOT = Path(__file__).resolve().parents[1]
KW = dict(max_batch=8, max_len=32)


def _cfg(arch, jax_pkg=False):
    get = jconfigs.get_smoke_config if jax_pkg else get_smoke_config
    return dataclasses.replace(get(arch), kv_cache_dtype="apack-int8")


def _requests(cls, cfg):
    rng = np.random.default_rng(0)
    return [cls(i, rng.integers(0, cfg.vocab_size, 9).astype(np.int32),
                max_new_tokens=8) for i in range(8)]


def _preempt(eng):
    for _ in range(3):
        eng.step()
    eng.preempt(2, spill=True)
    eng.preempt(5, spill=False)


def _serve(eng, cls, cfg, hook=None):
    reqs = _requests(cls, cfg)
    for r in reqs:
        eng.submit(r)
    if hook is not None:
        hook(eng)
    eng.run_until_drained()
    assert all(r.done and r.error is None for r in reqs), \
        [(r.rid, r.error) for r in reqs]
    return [list(r.tokens) for r in reqs]


@pytest.fixture(scope="module", params=["qwen3-1.7b", "hetero-serve-smoke"])
def arch(request):
    """Per arch: the port's params, and the tokens of the single-device
    engines of both packages (plain and with the preempts)."""
    name = request.param
    cfg_j, cfg = _cfg(name, True), _cfg(name)
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, jax.tree.map(np.array, params), "cpu")
    out = {"name": name, "cfg": cfg, "params": tp}
    hooks = {"plain": None}
    if name == "hetero-serve-smoke":
        hooks["preempt"] = _preempt
    for key, hook in hooks.items():
        out[f"jax_{key}"] = _serve(JEngine(cfg_j, params, kv_backend="ref",
                                           **KW), JRequest, cfg_j, hook)
        out[f"port_{key}"] = _serve(ServeEngine(cfg, tp, device="cpu", **KW),
                                    Request, cfg, hook)
    return out


def _mesh_engine(a, n_data, n_model, **kw):
    return ServeEngine(a["cfg"], a["params"], device="cpu",
                       mesh=make_debug_mesh(n_data, n_model, device="cpu"),
                       **KW, **kw)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_mesh_tokens_equal_single_device(arch, shape):
    """Greedy tokens on the mesh equal the single-device engines' (the
    port's and the JAX package's), and the single-device engines agree;
    on 4x2 the engine runs kernel 3 on two KV-head blocks a layer."""
    eng = _mesh_engine(arch, *shape)
    assert (eng._n_data, eng._n_model) == shape
    got = _serve(eng, Request, arch["cfg"])
    assert arch["port_plain"] == arch["jax_plain"]
    assert got == arch["port_plain"]
    st = eng.kv_stats()
    pps = eng.kv.pool.pages_per_shard
    assert st["kv_shard_free"] == [pps] * shape[0]
    assert st["kv_shard_reserved"] == [0] * shape[0]


@pytest.mark.parametrize("arch", ["qwen3-1.7b"], indirect=True)
def test_mesh_8x1_invariants(arch, monkeypatch):
    """Mid-serve, every request's pages lie in its slot's data-shard
    range and the per-shard stats add up; a step reads back one ``.cpu()``
    (its tokens) plus one pull a seal batch, no ``.item()``/``.tolist()``;
    after the drain every shard's free list is whole."""
    eng = _mesh_engine(arch, 8, 1)
    reqs = _requests(Request, arch["cfg"])
    for r in reqs:
        eng.submit(r)
    for _ in range(3):
        eng.step()
    pps = eng.kv.pool.pages_per_shard
    spb = eng.max_batch // 8
    for slot, r in enumerate(eng.active):
        assert r is not None
        for pids in eng.kv.page_tables[r.rid]:
            assert all(p // pps == slot // spb for p in pids), (slot, pids)
    st = eng.kv_stats()
    assert len(st["kv_shard_free"]) == len(st["kv_shard_reserved"]) == 8
    assert sum(st["kv_shard_reserved"]) == eng._reserved_total > 0
    calls = {"item": 0, "cpu": 0, "tolist": 0}

    def counting(name, orig):
        def f(*a, **k):
            calls[name] += 1
            return orig(*a, **k)
        return f
    for name in calls:
        monkeypatch.setattr(torch.Tensor, name,
                            counting(name, getattr(torch.Tensor, name)))
    for _ in range(3):
        d2h, before = eng.kv.transfers["d2h_calls"], dict(calls)
        eng.step()
        assert calls["item"] == before["item"]
        assert calls["tolist"] == before["tolist"]
        assert calls["cpu"] - before["cpu"] == \
            1 + eng.kv.transfers["d2h_calls"] - d2h
    monkeypatch.undo()
    eng.run_until_drained()
    assert [r.tokens for r in reqs] == arch["port_plain"]
    assert [eng.kv.pool.free_count_shard(s) for s in range(8)] == [pps] * 8
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


@pytest.mark.parametrize("arch", ["hetero-serve-smoke"], indirect=True)
def test_mesh_preempt_spill_resume(arch):
    """8x1 on ``hetero-serve-smoke``: slot 2 preempted with spill, slot 5
    without, after 3 steps, on both the mesh and the single-device
    engines; the spilled request may re-adopt into another shard."""
    eng = _mesh_engine(arch, 8, 1)
    got = _serve(eng, Request, arch["cfg"], _preempt)
    assert eng.stats["preempted"] == 2 and eng.stats["resumed"] == 2
    assert arch["port_preempt"] == arch["jax_preempt"]
    assert got == arch["port_preempt"]
    assert eng.kv.pool.free_count == eng.kv.pool.num_pages


def test_mesh_packed_teacher_forced():
    """1x2 from packed weights at tile 32 (K 64 and 128 in 2 and 4
    tiles): every packed site is a ``ShardedPackedWeight``, kernel 5 a
    model shard on its K half, the halves summed.  The mesh engine's
    sequences re-scored teacher-forced under its store and under the
    single-device packed engine's: logits within 0.05, the same argmax."""
    cfg = _cfg("qwen3-1.7b")
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kw = dict(weights="apack-int8", weight_min_size=1024, weight_tile_k=32)
    single = ServeEngine(cfg, params, device="cpu", **KW, **kw)
    mesh = ServeEngine(cfg, params, device="cpu",
                       mesh=make_debug_mesh(1, 2, device="cpu"), **KW, **kw)
    sites = [w for b in mesh.params["blocks"] for g in ("inner", "ffn")
             for w in b[g].values() if isinstance(w, pm.PackedWeight)]
    assert len(sites) == 7 * cfg.num_layers
    assert all(isinstance(w, pm.ShardedPackedWeight) and len(w.parts) == 2
               for w in sites)
    tokens = _serve(mesh, Request, cfg)
    worst = 0.0
    for r, toks in zip(_requests(Request, cfg), tokens):
        seq = torch.as_tensor([list(r.prompt) + toks[:-1]])
        a = PM.forward(cfg, mesh.params, seq)[0].float()
        b = PM.forward(cfg, single.params, seq)[0].float()
        worst = max(worst, float((a - b).abs().max()))
        assert torch.equal(a.argmax(-1), b.argmax(-1))
    assert worst <= 0.05


def test_cli_serves_a_mesh():
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
           "qwen3-1.7b", "--smoke", "--kv", "apack-int8", "--no-compress",
           "--mesh", "2x2", "--device", "cpu", "--requests", "4",
           "--prompt-len", "8", "--max-new", "4", "--max-batch", "4",
           "--kv-page-size", "4"]
    out = subprocess.run(cmd, env={"PYTHONPATH": str(ROOT / "src"),
                                   "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert any(ln.startswith("serving mesh: {'data': 2, 'model': 2} over 4 "
                             "devices (data=0,model=0 -> cpu")
               for ln in lines), out.stdout
    assert any("'completed': 4" in ln and "tok/s on cpu" in ln
               for ln in lines), out.stdout

"""The port's dry run (``repro_torch.launch``: ``specs``, ``costs``,
``dryrun``, ``report``, ``reanalyze``) and the prefill and decode cells on
a training mesh (``model.sharded_prefill``, ``model.sharded_decode_step``)
against the JAX package on the CPU.

- The shapes, the cell tables, ``skip_reason`` of every arch x shape,
  ``opt_config`` and ``batch_specs`` equal ``repro.launch.specs``'s
  (``batch_specs`` against the reference's ``ShapeDtypeStruct``s).
- The counter on ``tests/test_hlo_costs.py``'s toy programs: 2MKN for a
  matmul, a loop body counted once a trip (the reference multiplies a
  scanned body by its trips), nested loops, no collective bytes on one
  device, the ring wire model by collective kind.
- qwen3-1.7b SMOKE train, prefill and decode cells on one fake device:
  the matmul FLOPs equal an analytic sum of 2MNK exactly; the total FLOPs
  and bytes against ``hlo_costs.analyze`` of the reference cell compiled
  on the CPU, within the stated ratios (see ``test_cells_against_hlo``).
- recurrentgemma-9b SMOKE decode, batch 8, a 64-position cache, on a 2x4
  fake mesh (the counterpart of ``test_dryrun_cell_small_mesh_decode``):
  the cell runs and each device's argument bytes equal ``device_bytes``.
- The dry run's shortcut against the whole count; ``reanalyze``
  with unchanged constants reproduces the JSON; a fake tensor raises at
  every kernel wrapper.
- ``sharded_prefill``/``sharded_decode_step`` on one-device 2x2 CPU
  meshes (KV heads split, positions split, neither, a batch that does not
  split) against the port's ``prefill``/``decode_step`` and the jitted
  JAX ``prefill``/``decode_step``: logits within 0.05 (the parity tests'
  bound), greedy tokens equal.
"""
from __future__ import annotations

import dataclasses
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro import configs as jconfigs
from repro.launch import hlo_costs, specs as jspecs
from repro.models import config as jcfgmod
from repro.models import model as JM
from repro_torch import configs
from repro_torch.device import fake_device, fake_index
from repro_torch.kernels import (apack_decode, apack_encode,
                                 decompress_matmul, fused_page_attention,
                                 paged_decode)
from repro_torch.launch import costs, dryrun, reanalyze, report, specs
from repro_torch.launch.mesh import Mesh, make_debug_mesh
from repro_torch.models import config as pcfgmod
from repro_torch.models import model as PM
from repro_torch.models import sharding as sh
from repro_torch.models.convert import params_from_numpy

ATOL = 0.05


def _fake_mesh(nd: int, nm: int) -> Mesh:
    return Mesh(np.array([fake_device(i) for i in range(nd * nm)],
                         dtype=object).reshape(nd, nm))


def _smoke(monkeypatch):
    """Cells at SMOKE widths: the port's registry gives SMOKE configs."""
    monkeypatch.setattr(configs, "get_config", configs.get_smoke_config)


# ------------------------------------------------------------- the tables
def test_shapes_tables_and_skips_match_reference():
    assert [dataclasses.astuple(s) for s in pcfgmod.ALL_SHAPES] == \
        [dataclasses.astuple(s) for s in jcfgmod.ALL_SHAPES]
    for name in ("N_PATCH", "INT8_OPT", "GRAD_ACCUM", "BF16_ACCUM",
                 "FULL_ATTENTION_ARCHS"):
        assert getattr(specs, name) == getattr(jspecs, name), name
    assert [(a, s.name) for a, s in specs.all_cells()] == \
        [(a, s.name) for a, s in jspecs.all_cells()]
    for arch, shape in jspecs.all_cells():
        assert specs.skip_reason(arch, shape) == \
            jspecs.skip_reason(arch, shape), (arch, shape.name)
        assert specs.opt_config(arch).state_dtype == \
            jspecs.opt_config(arch).state_dtype


def test_batch_specs_match_reference():
    for arch, shape in jspecs.all_cells():
        want = jspecs.batch_specs(jconfigs.get_config(arch), shape)
        got = specs.batch_specs(configs.get_config(arch), shape)
        assert set(got) == set(want), arch
        for k, (shp, dt) in got.items():
            assert tuple(shp) == tuple(want[k].shape), (arch, shape.name, k)
            assert str(dt).split(".")[-1] == str(want[k].dtype), (arch, k)


def test_fake_mesh_beside_the_no_fallback_rule():
    """The dry run's production meshes are fake devices, one a shard
    (never folded); outside them, CUDA without a card still raises."""
    from repro_torch.device import resolve
    from repro_torch.launch.mesh import make_production_mesh
    for multi_pod, n in ((False, 256), (True, 512)):
        mesh = make_production_mesh(multi_pod=multi_pod, fake=True)
        assert [fake_index(d) for d in mesh.devices.flat] == list(range(n))
        assert len(set(mesh.devices.flat)) == n
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            resolve("cuda")
        with pytest.raises(RuntimeError):
            make_production_mesh()


# -------------------------------------------------------- the toy programs
def _count(fn, *shapes, dev=0):
    with FakeTensorMode():
        args = [torch.empty(s, device=fake_device(dev)) for s in shapes]
        c = costs.CostCounter()
        with c:
            fn(*args)
    return c.record()


def _flops(rec):
    return sum(d["flops"] for d in costs.per_device(rec).values())


def test_counter_toy_programs():
    m, k, n = 64, 128, 32
    rec = _count(lambda a, b: a @ b, (m, k), (k, n))
    assert _flops(rec) == 2 * m * k * n
    assert costs.by_op(rec)["mm"][2] == 4 * (m * k + k * n + m * n)

    L, d = 8, 32

    def scan(ws, x):
        h = x
        for i in range(L):
            h = torch.tanh(h @ ws[i])
        return h
    rec = _count(scan, (L, d, d), (d, d))
    assert _flops(rec) == L * (2 * d * d * d + d * d)      # a body a trip

    def nested(x):
        for _ in range(3):
            for _ in range(5):
                x = x * 2.0
        return x
    rec = _count(nested, (16,))
    assert _flops(rec) == 3 * 5 * 16
    assert costs.collectives(rec) == {}
    assert costs.link_bytes(rec, 8) == {}


def test_counter_collectives_ring_model():
    """An all-gather of four f32[1024] blocks onto device 0 moves three
    of them once; a psum twice its moved operands (the ring all-reduce);
    a copy outside a collective is a ``copy``; NVLink within a host of 8,
    the network between hosts."""
    mesh = _fake_mesh(1, 16)
    with FakeTensorMode():
        parts = [torch.empty(1024, device=mesh.devices[0, j])
                 for j in range(4)]
        far = torch.empty(1024, device=mesh.devices[0, 9])
        c = costs.CostCounter()
        with c:
            sh.all_gather(parts, 0, mesh.devices[0, 0])
            sh.psum(parts, mesh.devices[0, 0])
            far.to(mesh.devices[0, 1])
    rec = c.record()
    kinds = costs.collectives(rec)
    assert kinds["all-gather"] == {"calls": 3, "operand_bytes": 3 * 4096,
                                   "wire_bytes": 3 * 4096}
    assert kinds["all-reduce"] == {"calls": 3, "operand_bytes": 3 * 4096,
                                   "wire_bytes": 6 * 4096}
    assert kinds["copy"]["operand_bytes"] == 4096
    links = costs.link_bytes(rec, 8)
    assert links[0]["in"] == {"nvlink": 6 * 4096}
    assert links[1]["in"] == {"network": 4096}
    assert links[9]["out"] == {"network": 4096}


# ------------------------------------------------------------ SMOKE cells
def _shapes():
    return {"train": pcfgmod.ShapeConfig("t", "train", 64, 4),
            "prefill": pcfgmod.ShapeConfig("p", "prefill", 64, 2),
            "decode": pcfgmod.ShapeConfig("d", "decode", 64, 4)}


def _mnk(cfg, kind: str, b: int, s: int) -> int:
    """2MNK of every matmul of qwen3's cell at ``b`` rows of ``s``
    positions (training: the forward and, for each product, the two of
    its backward)."""
    d, h, hkv, dh, f, v = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.vocab_size)
    q = 1 if kind == "decode" else s             # query positions a row
    keys = s
    layer = 2 * b * q * d * (h + 2 * hkv) * dh + 2 * b * q * h * dh * d \
        + 3 * 2 * b * q * d * f + 2 * 2 * b * h * q * keys * dh
    head = 2 * b * (s if kind == "train" else 1) * d * v
    fwd = cfg.num_layers * layer + head
    return 3 * fwd if kind == "train" else fwd


def _jax_cell(kind, shape):
    cfg = jconfigs.get_smoke_config("qwen3-1.7b")
    params = jax.eval_shape(lambda: JM.init_params(cfg, jax.random.PRNGKey(0)))
    b = jspecs.batch_specs(cfg, shape)
    if kind == "train":
        from repro.train.train_step import make_train_step
        ocfg = jspecs.opt_config("qwen3-1.7b")
        from repro.train import optimizer
        st = jax.eval_shape(lambda p: optimizer.init_state(ocfg, p), params)
        step = make_train_step(cfg, ocfg, grad_accum=2)
        lowered = jax.jit(step).lower(params, st, b)
        trips = {0: 2, 1: cfg.n_cycles, 2: 1, 3: 256}
    elif kind == "prefill":
        lowered = jax.jit(lambda p, x: JM.prefill(cfg, p, x)).lower(params, b)
        trips = {0: cfg.n_cycles, 1: 1, 2: 256}
    else:
        cache = jax.eval_shape(lambda: JM.init_cache(cfg, shape.global_batch,
                                                     shape.seq_len))
        pos = jax.ShapeDtypeStruct((), jnp.int32)
        lowered = jax.jit(lambda p, c, x, q: JM.decode_step(
            cfg, p, c, x["tokens"], q)).lower(params, cache, b, pos)
        trips = {0: cfg.n_cycles, 1: 1, 2: 1}
    return hlo_costs.analyze(lowered.compile().as_text(), trips)


# The port's total FLOPs and bytes over the reference's HLO walk of the same
# SMOKE cell compiled on the CPU (measured: train 0.791 / 1.051, prefill
# 0.978 / 1.371, decode 0.961 / 0.529).  FLOPs: the reference's train step
# recomputes each cycle's forward in its backward (remat, 4/3 of the
# matmuls) and the port's mesh step does not; XLA fuses and simplifies
# some elementwise work the port's eager rounding points keep.  Bytes: an
# eager op writes its result where XLA fuses an elementwise chain into one
# pass (prefill), while the reference's decode scan moves the stacked
# cache through its loop (dynamic slices of the whole cache a layer,
# counted twice) where the port reads each layer's cache in place.
HLO_RATIO = {"train": ((0.7, 0.85), (0.9, 1.3)),
             "prefill": ((0.9, 1.1), (1.1, 1.6)),
             "decode": ((0.9, 1.1), (0.4, 0.7))}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_cells_against_hlo(kind, monkeypatch):
    """The matmul FLOPs of a qwen3 SMOKE cell on one fake device equal
    2MNK summed by hand exactly; its total FLOPs and bytes against the
    reference cell's HLO walk within ``HLO_RATIO``."""
    _smoke(monkeypatch)
    shape = _shapes()[kind]
    mesh = _fake_mesh(1, 1)
    with dryrun.fake_mode(), sh.mesh_context(mesh):
        rec, cell = dryrun.count_cell("qwen3-1.7b", shape, mesh, {"ga": 2})
    ops = costs.by_op(rec)
    mm = sum(ops[k][1] for k in ("mm", "bmm", "addmm") if k in ops)
    assert mm == _mnk(cell.cfg, kind, shape.global_batch, shape.seq_len)
    ref = _jax_cell(kind, shape)
    flops = _flops(rec)
    byts = sum(d["bytes"] for d in costs.per_device(rec).values())
    (flo, fhi), (blo, bhi) = HLO_RATIO[kind]
    assert flo <= flops / ref["flops"] <= fhi, (flops, ref["flops"])
    assert blo <= byts / ref["bytes"] <= bhi, (byts, ref["bytes"])


def test_small_mesh_decode_cell(monkeypatch):
    """recurrentgemma-9b SMOKE decode, batch 8, a 64-position cache, on a
    2x4 fake mesh: the cell runs, and each device's argument bytes equal
    ``device_bytes`` of the placed trees at its coordinate."""
    _smoke(monkeypatch)
    mesh = _fake_mesh(2, 4)
    shape = pcfgmod.ShapeConfig("d", "decode", 64, 8)
    with dryrun.fake_mode(), sh.mesh_context(mesh):
        rec, cell = dryrun.count_cell("recurrentgemma-9b", shape, mesh, {})
    per = {}
    for t in cell.args.values():
        for idx, n in sh.device_bytes(t).items():
            d = fake_index(mesh.devices[idx])
            per[d] = per.get(d, 0) + n
    assert {int(k): v for k, v in rec["args"].items()} == per
    assert len(per) == 8
    assert all(rec["peak"][str(d)] >= per[d] for d in per)
    assert _flops(rec) > 0


def test_shortcut_against_whole_count(monkeypatch):
    """A train cell's three cycles counted whole against none and one
    extrapolated, and four microbatches against two and three
    (``dryrun._extrapolate``): FLOPs, bytes, collective bytes and
    argument bytes equal; each device's peak within 1% (measured: equal
    for the cycles, 0.02% off for the microbatches; a train step peaks as
    its backward starts, holding every cycle's saved tensors, which are
    the same size a cycle)."""
    _smoke(monkeypatch)
    mesh = _fake_mesh(2, 1)
    shape = pcfgmod.ShapeConfig("t", "train", 16, 4)
    with dryrun.fake_mode(), sh.mesh_context(mesh):
        recs = [dryrun.count_cell("qwen3-1.7b", shape, mesh, {"ga": 1},
                                  cycles=c)[0] for c in (0, 1, 3)]
        mbs = {g: dryrun.count_cell("qwen3-1.7b", shape, mesh, {"ga": g},
                                    cycles=1, global_batch=2 * g)[0]
               for g in (2, 3, 4)}
    got = dryrun._extrapolate({(c,): r for c, r in zip((0, 1), recs)},
                              [([0, 1], 4, False)])
    assert costs.per_device(got) == costs.per_device(recs[2])
    assert costs.collectives(got) == costs.collectives(recs[2])
    assert got["args"] == recs[2]["args"]
    for d, p in recs[2]["peak"].items():
        assert abs(got["peak"][d] - p) <= 0.01 * p, (d, got["peak"][d], p)
    got = dryrun._extrapolate({(g,): mbs[g] for g in (2, 3)},
                              [([2, 3], 3, True)])
    assert costs.per_device(got) == costs.per_device(mbs[4])
    assert costs.collectives(got) == costs.collectives(mbs[4])
    for d, p in mbs[4]["peak"].items():
        assert abs(got["peak"][d] - p) <= 0.01 * p, (d, got["peak"][d], p)


def test_run_cell_json_and_reanalyze(monkeypatch, tmp_path):
    """``run_cell`` writes a cell's JSON and its per-op record;
    ``reanalyze`` with the same constants rewrites the same JSON, the
    report has its row."""
    _smoke(monkeypatch)
    monkeypatch.setattr(dryrun, "make_production_mesh",
                        lambda multi_pod, fake: _fake_mesh(2, 2))
    r = dryrun.run_cell("qwen3-1.7b", "decode_32k", False, tmp_path,
                        variant={})
    assert r["status"] == "ok" and r["count_s"] > 0
    path = tmp_path / "qwen3-1.7b__decode_32k__16x16.json"
    before = json.loads(path.read_text())
    rec = json.loads(gzip.decompress(
        (tmp_path / "qwen3-1.7b__decode_32k__16x16.ops.json.gz").read_bytes()))
    assert rec["ops"]
    assert reanalyze.reanalyze(tmp_path) == 1
    assert json.loads(path.read_text()) == before
    rows = report.rows(tmp_path)
    assert len(rows) == 1 and "qwen3-1.7b | decode_32k" in rows[0]
    skip = dryrun.run_cell("qwen3-1.7b", "long_500k", False, None)
    assert skip["status"] == "skip"


@pytest.mark.parametrize("device", ["cuda:0", "meta:3"])
def test_fake_tensor_raises_at_every_kernel_wrapper(device):
    """A fake tensor takes neither the kernel nor the plain version."""
    def t(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device=device)

    with FakeTensorMode():
        calls = [
            lambda: apack_decode.decode(t(2, 3, 4), t(2, 3, 4), t(2, 4),
                                        t(17), t(16), t(17), n_steps=4),
            lambda: apack_encode.encode(t(2, 4, 4), t(17), t(16), t(17),
                                        n_steps=4),
            lambda: paged_decode.gather_decode(
                t(2, 3, 4), t(2, 3, 4), t(2, 4), t(2), t(17), t(16),
                t(17), n_steps=4),
            lambda: paged_decode.launch_gather_decode(
                t(2, 3, 4), t(2, 3, 4), t(2, 4), t(2), t(2), t(17), t(16),
                t(17), n_steps=4),
            lambda: fused_page_attention.fused_page_attention(
                t(2, 4, 8, dtype=torch.float32), t(2, 3), t(2, 3),
                t(2, 3, 2), t(2, 2), {"tok_k": t(2, 4)}, n_steps=4),
        ]
        cw = decompress_matmul.CompressedLinear.__new__(
            decompress_matmul.CompressedLinear)
        cw.sym_plane = t(3, 4)
        cw.scale = t(4, dtype=torch.float32)
        calls.append(lambda: decompress_matmul.compressed_matmul(
            t(2, 4, dtype=torch.float32), cw))
        for call in calls:
            with pytest.raises(RuntimeError, match="fake tensor"):
                call()


# ----------------------------------------- prefill and decode on a mesh
def _mesh_case(arch, window=None):
    cfg_j = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    if window:
        cfg_j = dataclasses.replace(cfg_j, window_size=window)
        cfg = dataclasses.replace(cfg, window_size=window)
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tp = PM.serving_params(params_from_numpy(cfg, jax.tree.map(np.array, jp),
                                             "cpu"))
    return cfg_j, cfg, jp, tp


@pytest.fixture(scope="module")
def mesh_cases():
    return {"qwen3-1.7b": _mesh_case("qwen3-1.7b"),
            "recurrentgemma-9b": _mesh_case("recurrentgemma-9b", 8)}


@pytest.mark.parametrize("arch,rows,layouts", [
    ("qwen3-1.7b", 4, {"heads"}),
    ("qwen3-1.7b", 1, {"whole"}),
    ("recurrentgemma-9b", 4, {"whole", "sequence"}),
])
def test_sharded_prefill_and_decode_match(mesh_cases, arch, rows, layouts):
    """``sharded_prefill`` and three ``sharded_decode_step``s on a 2x2
    one-device CPU mesh: logits within 0.05 of the port's ``prefill``/
    ``decode_step`` and of the jitted JAX ``prefill``/``decode_step``,
    greedy tokens equal; the prefill's caches gathered equal the port's;
    the decode's layouts as named."""
    cfg_j, cfg, jp, tp = mesh_cases[arch]
    mesh = make_debug_mesh(2, 2, device="cpu")
    s, cap = 12, 24
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, (rows, s))
    tt = torch.from_numpy(toks).long()
    pl, pc = PM.prefill(cfg, tp, tt)
    jl, jc = jax.jit(lambda p, t: JM.prefill(cfg_j, p, {"tokens": t}, cap))(
        jp, jnp.asarray(toks, jnp.int32))
    ps = sh.place_tree(tp, sh.param_shardings(mesh, tp))
    bs = sh.place_tree({"tokens": tt}, sh.batch_shardings(mesh,
                                                          {"tokens": tt}))
    with torch.no_grad():
        ml, mc = PM.sharded_prefill(cfg, ps, bs, mesh)
    np.testing.assert_allclose(ml.numpy(), pl.numpy(), atol=ATOL)
    np.testing.assert_allclose(ml.numpy(), np.asarray(jl), atol=ATOL)
    assert np.array_equal(ml.numpy().argmax(-1), np.asarray(jl).argmax(-1))
    split = bs["tokens"].spec[0] is not None
    for got, want in zip(PM.gather_prefill_caches(mc, "cpu", split), pc):
        for f in want:
            assert torch.equal(got[f], want[f]), f
    dense = PM.extend_caches(cfg, pc, cap)
    placed = sh.place_tree(dense, sh.cache_shardings(mesh, dense))
    assert {PM._decode_layout(c, 2) for c in placed} == layouts
    one = [{f: t.clone() for f, t in c.items()} for c in dense]
    nxt = ml.argmax(-1)
    jcache = jc
    for step in range(3):
        pos = s + step
        want, one = PM.decode_step(cfg, tp, one, nxt,
                                   torch.full((rows,), pos))
        jlog, jcache = jax.jit(lambda p, c, t, q: JM.decode_step(
            cfg_j, p, c, t, q))(jp, jcache, jnp.asarray(nxt.numpy(),
                                                          jnp.int32),
                                jnp.int32(pos))
        tk = sh.place_tree({"tokens": nxt}, sh.batch_shardings(
            mesh, {"tokens": nxt}))["tokens"]
        pp = sh.Sharded.place(torch.tensor(pos), sh.NamedSharding(mesh, ()))
        with torch.no_grad():
            got, placed = PM.sharded_decode_step(cfg, ps, placed, tk, pp,
                                                 mesh)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=ATOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), atol=ATOL)
        assert np.array_equal(got.argmax(-1).numpy(),
                              np.asarray(jlog).argmax(-1)), step
        nxt = want.argmax(-1)

"""The port's serving mesh rules, sharded pool, sharded kernels' plain
versions and the int8 gradient all-reduce against the JAX package on the
CPU (qwen3-1.7b SMOKE widths):

- ``sharding.plane_pspec``/``plane_pspecs`` (and the unknown-name
  ``KeyError``) and ``fit_spec`` equal ``repro.models.sharding``'s;
- ``model.packed_param_specs`` at 1 and 2 model shards equals the JAX
  package's on the same packed SMOKE params, site by site (the JAX
  stacked leaves' leading layer axis dropped);
- ``KVPagePool(n_shards=)`` as ``tests/test_mesh_serving.py``'s
  ``TestShardedPool`` holds the JAX pool;
- the engine's six mesh refusals with the reference's messages
  (``TestMeshValidation``, on a ``FakeMesh``: every one raises before the
  engine touches a device);
- kernel 3's plain version on two model shards' head blocks (jobmeta
  ``(qpos, window, h0)``, dense planes of the block's heads, PACKED
  planes whole) against the JAX ``fused_page_attention`` (``ref`` and
  Pallas interpret) at f32 rtol 1e-5 / atol 1e-6, and the two blocks
  side by side bit-equal to the full-head plain version;
- kernel 5's plain version on two K halves (``split_k``), summed, against
  the whole product within the K-term f32 bound;
- ``compressed_psum_mean`` bit-equal to the JAX package's on a one-device
  mesh, against a numpy restatement of its arithmetic for 4 replicas,
  and the error-feedback and equal-replica properties of
  ``tests/test_distributed.py:67-86``."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.kernels import fused_page_attention as jfpa
from repro.models import model as JM
from repro.models import sharding as jsh
from repro.train import compress_grads as jcg
from repro_torch.configs import get_smoke_config
from repro_torch.core import quant as pquant
from repro_torch.kernels import decompress_matmul as pdm
from repro_torch.kernels import fused_page_attention as pfpa
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models import sharding as psh
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import ServeEngine
from repro_torch.train import compress_grads as pcg
from test_torch_fused_attention import DH, E, H, HQ, _pool, _tables


class FakeMesh:
    """Axis sizes only: what ``fit_spec`` and the engine's validation
    read."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


# ------------------------------------------------------------- the rules
def test_plane_rules_equal_the_reference():
    assert set(psh.plane_pspecs()) == set(jsh.plane_pspecs())
    for name, spec in jsh.plane_pspecs().items():
        assert psh.plane_pspec(name) == tuple(spec), name
    assert set(psh.plane_pspecs({"tok_k": 0, "vm": 0})) == {"tok_k", "vm"}
    for mod in (psh, jsh):
        with pytest.raises(KeyError, match="no plane partition rule"):
            mod.plane_pspec("nope")
    assert psh.PACKED_LEAF_KINDS == jsh.PACKED_LEAF_KINDS


@pytest.mark.parametrize("spec,shape,mesh", [
    (("data", "model"), (256, 8), dict(data=16, model=16)),
    ((("data", "model"), None), (512, 7), dict(data=16, model=16)),
    ((("data", "model"), None), (100, 7), dict(data=16, model=16)),
    (("data", None, "model", None), (8, 4, 2, 16), dict(data=1, model=16)),
    (("data", None, "model", None), (8, 4, 2, 16), dict(data=2, model=2)),
    (("data", "model"), (9, 4), dict(data=2, model=2)),
])
def test_fit_spec_equals_the_reference(spec, shape, mesh):
    m = FakeMesh(**mesh)
    assert psh.fit_spec(spec, shape, m) == tuple(
        jsh.fit_spec(P(*spec), shape, m))


@pytest.fixture(scope="module")
def packed_smoke():
    """qwen3 SMOKE params packed by both packages at tile 32 (K 64 and 128
    in 2 and 4 K tiles, so that the sites split 2 ways)."""
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg_p = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    jpacked, _ = JM.pack_weights(cfg_j, params, min_size=1024, tile_k=32)
    tp = params_from_numpy(cfg_p, jax.tree.map(np.array, params), "cpu")
    ppacked, _ = PM.pack_weights(cfg_p, tp, min_size=1024, tile_k=32)
    return cfg_p, jpacked, ppacked


@pytest.mark.parametrize("n_model", [1, 2])
def test_packed_param_specs_equal_the_reference(packed_smoke, n_model):
    cfg, jpacked, ppacked = packed_smoke
    jspecs = JM.packed_param_specs(jpacked, n_model)
    pspecs = PM.packed_param_specs(ppacked, n_model)
    n_cycle = len(cfg.cycle)
    sites = 0
    for layer, blk in enumerate(ppacked["blocks"]):
        c = layer % n_cycle
        for grp in ("inner", "ffn"):
            for name, leaf in blk[grp].items():
                got = pspecs["blocks"][layer][grp][name]
                want = jspecs["blocks"][c][grp][name]
                if not isinstance(leaf, pm.PackedWeight):
                    assert got == () and tuple(want) == ()
                    continue
                leaves = jax.tree_util.tree_leaves(
                    want, is_leaf=lambda x: isinstance(x, P))
                # the JAX leaves stack the layers on a leading axis
                assert got == [tuple(s)[1:] if len(s) else () for s in leaves]
                sites += 1
                split = [s for s in got if "model" in s]
                assert len(split) == (3 if n_model == 2 else 0)
    assert sites == 7 * cfg.num_layers
    assert pspecs["embed"] == ()


# --------------------------------------------------------- the sharded pool
@pytest.mark.parametrize("case", ["in_range", "exhausted", "free_routes",
                                  "free_count", "indivisible", "single"])
def test_sharded_pool(case):
    """``TestShardedPool`` (``tests/test_mesh_serving.py:50-99``) on the
    port's pool, each case beside the JAX pool where it has one."""
    from repro.models import modules as jmm

    def pools(num_pages=16, n_shards=4):
        return (pm.KVPagePool(num_pages, 4, 2, 8, n_shards=n_shards,
                              device="cpu"),
                jmm.KVPagePool(num_pages, page_size=4, kv_heads=2,
                               head_dim=8, n_shards=n_shards))
    if case == "indivisible":
        for mk in (lambda: pm.KVPagePool(14, 4, 2, 8, n_shards=4,
                                         device="cpu"),
                   lambda: jmm.KVPagePool(14, page_size=4, kv_heads=2,
                                          head_dim=8, n_shards=4)):
            with pytest.raises(ValueError, match="split evenly"):
                mk()
        return
    pool, jpool = pools(n_shards=1 if case == "single" else 4)
    for p_, free in ((pool, pool.free),
                     (jpool, lambda ids: [jpool.free(i) for i in ids])):
        if case == "in_range":
            for shard in range(4):
                for _ in range(4):
                    pid = p_.alloc(shard)
                    assert shard * 4 <= pid < (shard + 1) * 4
                    assert p_.shard_of(pid) == shard
        elif case == "exhausted":
            for _ in range(4):
                assert p_.alloc(1) is not None
            assert p_.alloc(1) is None
            assert p_.free_count_shard(1) == 0
            for shard in (0, 2, 3):
                assert p_.alloc(shard) is not None
        elif case == "free_routes":
            free([p_.alloc(2) for _ in range(4)])
            assert p_.free_count_shard(2) == 4
            assert p_.shard_of(p_.alloc(2)) == 2
        elif case == "free_count":
            p_.alloc(0), p_.alloc(3)
            assert p_.free_count == sum(p_.free_count_shard(s)
                                        for s in range(4)) == 14
        else:
            # one shard is the single free list, lowest id first
            assert [p_.alloc() for _ in range(4)] == [0, 1, 2, 3]
    if case == "single":
        assert pool.plane("sym") is pool.parts[0][0]["sym"]   # whole planes
    else:
        with pytest.raises(ValueError, match="no whole plane"):
            pool.plane("sym")
    assert pool.free_lists == jpool.free_lists


def test_sharded_pool_reads_and_writes_across_shards():
    """A pool of 2 data x 2 model shards: pages written with every head
    read back whole, the dense planes split by head (each model shard its
    block), the PACKED planes whole on both model shards."""
    from repro_torch.launch.mesh import make_debug_mesh
    pool = pm.KVPagePool(8, 4, 2, 8, n_shards=2, device="cpu",
                         mesh=make_debug_mesh(2, 2, device="cpu"))
    pids = [pool.alloc(1), pool.alloc(0), pool.alloc(1)]
    ix = pool.index(pids)
    g = torch.Generator().manual_seed(0)
    q = torch.randint(-127, 128, (2, 3, 4, 2, 8), generator=g,
                      dtype=torch.int8)
    sym = torch.randint(0, 2 ** 30, (2, 3, pool.sym_words, pool.n_streams),
                        generator=g, dtype=torch.int32)
    pool.write("cold_q", ix, q)
    pool.write("sym", ix, sym)
    assert torch.equal(pool.read("cold_q", ix), q)
    assert torch.equal(pool.read("sym", ix), sym)
    part = pool.parts[1][1]
    assert part["cold_q"].shape == (2, 4, 4, 1, 8)
    assert torch.equal(part["cold_q"][:, pids[0] - 4], q[:, 0, :, 1:])
    assert torch.equal(pool.parts[1][0]["sym"][:, pids[2] - 4], sym[:, 2])
    assert torch.equal(pool.parts[1][1]["sym"][:, pids[2] - 4], sym[:, 2])
    pool.free(pids)
    assert not pool.read("cold_q", ix).any()


# ----------------------------------------------------- the engine refuses
@pytest.mark.parametrize("case", ["fused_paged_kv", "not_materialize",
                                  "sync_scheduler", "data_axis", "max_batch",
                                  "kv_heads"])
def test_mesh_validation(case):
    """``TestMeshValidation`` (``tests/test_mesh_serving.py:112-147``) on
    the port's engine, with the reference's messages, each raised before
    any device work."""
    cfg = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                              kv_cache_dtype="apack-int8")
    kw, mesh = {}, FakeMesh(data=2, model=1)
    match = {"fused_paged_kv": "fused paged apack-int8",
             "not_materialize": "fused paged apack-int8",
             "sync_scheduler": "scheduler='sync'", "data_axis": "'data' axis",
             "max_batch": "max_batch", "kv_heads": "num_kv_heads"}[case]
    if case == "fused_paged_kv":
        cfg = dataclasses.replace(cfg, kv_cache_dtype="bfloat16")
    elif case == "not_materialize":
        kw["kv_fused"] = False
    elif case == "sync_scheduler":
        kw["scheduler"] = "async"
    elif case == "data_axis":
        mesh = FakeMesh(model=2)
    elif case == "max_batch":
        mesh = FakeMesh(data=3, model=1)
    else:
        mesh = FakeMesh(data=1, model=3)        # 2 KV heads over 3
    params = PM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match=match):
        ServeEngine(cfg, params, max_batch=8, max_len=32, mesh=mesh,
                    device="cpu", **kw)


# ---------------------------------------------- the sharded kernels' plain
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (6, 5.0)])
def test_attention_head_blocks_match_reference(window, softcap):
    rng = np.random.default_rng(40 + window)
    planes = _pool(rng)
    jobs, slots = 3, 6
    pid, tid, meta, qpos = _tables(rng, jobs, slots)
    win = np.full(jobs, window, np.int32)
    q = rng.normal(0, 1, (jobs, HQ, DH)).astype(np.float32)
    tp = {k: torch.from_numpy(v.view(np.int32) if v.dtype == np.uint32 else v)
          for k, v in planes.items()}
    args = [torch.from_numpy(a) for a in (pid, tid, meta)]
    kw = dict(n_steps=E, softcap=softcap)
    full = pfpa.fused_page_attention_plain(
        torch.from_numpy(q), *args, torch.from_numpy(np.stack([qpos, win], -1)),
        tp, **kw)
    parts = []
    for j in range(2):                         # one KV head a model shard
        shard = dict(tp)
        jshard = dict(planes)
        for key, ax in (("tok_k", 2), ("tok_v", 2), ("cold_k", 2),
                        ("cold_v", 2), ("tok_sk", 2), ("tok_sv", 2),
                        ("pscale_k", 1), ("pscale_v", 1)):
            shard[key] = tp[key].narrow(ax, j, 1).contiguous()
            jshard[key] = np.ascontiguousarray(
                np.take(planes[key], [j], axis=ax))
        jm = np.stack([qpos, win, np.full(jobs, j, np.int32)], -1)
        qj = q[:, j * HQ // 2:(j + 1) * HQ // 2]
        got = pfpa.fused_page_attention(
            torch.from_numpy(np.ascontiguousarray(qj)), *args,
            torch.from_numpy(jm), shard, h_full=H, **kw)
        jargs = (jnp.asarray(qj), jnp.asarray(pid), jnp.asarray(tid),
                 jnp.asarray(meta), jnp.asarray(jm))
        for backend in ("ref", "pallas_interpret"):
            want = jfpa.fused_page_attention(
                *jargs, {k: jnp.asarray(v) for k, v in jshard.items()},
                n_steps=E, num_heads=HQ // 2, h_full=H, softcap=softcap,
                backend=backend)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           rtol=1e-5, atol=1e-6)
        parts.append(got)
    for i in range(3):
        assert torch.equal(torch.cat([p_[i] for p_ in parts], dim=1), full[i])


def test_matmul_k_halves_sum_to_the_whole():
    """Kernel 5's plain version on the two K halves of a [256, 200] weight
    in tiles of 32 (8 K tiles), summed (``psum``), against the whole
    product within the K-term f32 bound."""
    rs = np.random.RandomState(3)
    w = torch.from_numpy((rs.standard_normal((256, 200)) * 0.05)
                         .astype(np.float32))
    q, qp = pquant.quantize_symmetric(w, axis=-1)
    cw = pdm.compress_quantized(q, qp.scale.reshape(-1), 32)
    assert pdm.k_splittable(cw, 2) and not pdm.k_splittable(cw, 3)
    x = torch.from_numpy(rs.standard_normal((4, 256)).astype(np.float32))
    halves = pdm.split_k(cw, 2)
    assert [h.k for h in halves] == [128, 128]
    ys = [pdm.compressed_matmul(x[:, j * 128:(j + 1) * 128], h)
          for j, h in enumerate(halves)]
    got = psh.psum(ys, x.device).double()
    want = pdm.compressed_matmul(x, cw).double()
    wf = (q.float() * qp.scale.reshape(1, -1)).double()
    bound = 256 * 2.0 ** -24 * (x.double().abs() @ wf.abs())
    assert bool(((got - want).abs() <= bound).all())
    pw = pm.ShardedPackedWeight(pdm.Layout.of(cw), (256, 200), 1, "float32",
                                halves)
    assert torch.equal(pw.matmul(x), psh.psum(ys, x.device))


def test_shard_params_split_each_weight_once_a_device():
    """``shard_params`` on a 2 x 2 grid of one device: the dense leaves
    and an unsplit packed weight are the given tensors; a K-split weight
    is cut once, its two K ranges shared by both data shards, and keeps
    no whole planes beside them (its ``cw`` is a tensor-free layout)."""
    rs = np.random.RandomState(4)
    w = torch.from_numpy((rs.standard_normal((256, 200)) * 0.05)
                         .astype(np.float32))
    q, qp = pquant.quantize_symmetric(w, axis=-1)
    cw = pdm.compress_quantized(q, qp.scale.reshape(-1), 32)
    odd = pdm.compress_quantized(q[:96], qp.scale.reshape(-1), 32)
    dense = torch.ones(3)
    params = {"d": dense, "w": [pm.PackedWeight(cw, (256, 200), 1, "f32")],
              "o": pm.PackedWeight(odd, (96, 200), 1, "f32")}
    cpu = torch.device("cpu")
    shards = PM.shard_params(params, [[cpu, cpu], [cpu, cpu]])
    assert len(shards) == 2
    for sh in shards:
        assert sh["d"] is dense
        assert type(sh["o"]) is pm.PackedWeight
        assert sh["o"].cw.sym_plane is odd.sym_plane   # 3 K tiles: whole
        sw = sh["w"][0]
        assert isinstance(sw, pm.ShardedPackedWeight)
        assert sw.cw == pdm.Layout.of(cw) and len(sw.parts) == 2
        assert sw.parts[0].scale is cw.scale
    for j in range(2):
        assert shards[0]["w"][0].parts[j].sym_plane is \
            shards[1]["w"][0].parts[j].sym_plane
    x = torch.from_numpy(rs.standard_normal((4, 256)).astype(np.float32))
    want = pdm.compressed_matmul(x, cw).double()
    got = shards[1]["w"][0].matmul(x).double()
    assert float((got - want).abs().max()) <= 1e-5


# ------------------------------------------------- the gradient all-reduce
def _grads(rng, scale=1e-3):
    return {"w": rng.normal(0, scale, (3000,)).astype(np.float32),
            "b": rng.normal(0, 1, (7, 5)).astype(np.float32)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def test_compressed_psum_mean_equals_reference_on_one_device():
    rng = np.random.default_rng(0)
    g, e = _grads(rng), _grads(rng, 1e-5)
    mesh = jax.make_mesh((1,), ("data",))
    jo, je = jcg.compressed_psum_mean(jax.tree.map(jnp.asarray, g), mesh,
                                      ("data",), jax.tree.map(jnp.asarray, e))
    po, pe = pcg.compressed_psum_mean([_t(g)], FakeMesh(data=1), ("data",),
                                      [_t(e)])
    for k in g:
        np.testing.assert_array_equal(po[0][k].numpy(), np.asarray(jo[k]))
        np.testing.assert_array_equal(pe[0][k].numpy(), np.asarray(je[k]))


def test_compressed_psum_mean_over_four_replicas():
    """4 replicas with different gradients and feedback, against numpy
    following the reference's arithmetic step by step (eager: ``/ 127``
    divides); every replica gets the same mean."""
    rng = np.random.default_rng(1)
    gs = [_grads(rng) for _ in range(4)]
    es = [_grads(rng, 1e-5) for _ in range(4)]
    means, errs = pcg.compressed_psum_mean(
        [_t(g) for g in gs], FakeMesh(data=2, model=2), ("data", "model"),
        [_t(e) for e in es])
    for k in gs[0]:
        qs, ss, want_err = [], [], []
        for g, e in zip(gs, es):
            x = g[k].astype(np.float32) + e[k]
            flat = x.reshape(-1)
            n = flat.size
            blocks = np.pad(flat, (0, -n % 512)).reshape(-1, 512)
            s = np.maximum(np.abs(blocks).max(1), np.float32(1e-20)) \
                / np.float32(127)
            q = np.clip(np.round(blocks / s[:, None]), -127, 127)
            want_err.append(x - (q * s[:, None]).reshape(-1)[:n]
                            .reshape(x.shape))
            qs.append(q.astype(np.float32))
            ss.append(s.astype(np.float32))
        smax = np.maximum.reduce(ss)
        tot = sum(np.clip(np.round(q * (s / smax)[:, None]), -127, 127)
                  .astype(np.int32) for q, s in zip(qs, ss))
        want = ((tot.astype(np.float32) * smax[:, None]).reshape(-1)[:n]
                .reshape(gs[0][k].shape) / np.float32(4)).astype(np.float32)
        for r in range(4):
            np.testing.assert_array_equal(means[r][k].numpy(), want)
            np.testing.assert_array_equal(errs[r][k].numpy(), want_err[r])


def test_compressed_psum_mean_properties():
    """``tests/test_distributed.py:67-86``: replicas that all hold the same
    gradient get it back within the largest block scale, and the new error
    feedback plus the mean gives the gradient."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(0, 1e-3, (2048,))
                               .astype(np.float32))}
    means, errs = pcg.compressed_psum_mean([g] * 8, FakeMesh(data=8),
                                           ("data",))
    _, s, _ = pcg.quantize_blockwise(g["w"])
    tol = float(s.max()) * 1.01
    for out, err in zip(means, errs):
        assert float((out["w"] - g["w"]).abs().max()) <= tol
        assert float((err["w"] + out["w"] - g["w"]).abs().max()) < 1e-6

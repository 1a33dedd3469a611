"""Sharded training of the port on the CPU, against the JAX package:

- the training rules (``sharding.param_shardings``, with the ``moe_ep``
  variant, ``cache_shardings``, ``batch_shardings``,
  ``logits_sharding``) equal
  ``repro.models.sharding``'s leaf by leaf for every registered arch, on
  SMOKE trees and on full-size shapes (``meta`` tensors, ``eval_shape``)
  on a 16 x 16 ``FakeMesh`` and a 2 x 16 x 16 one with a pod axis; the
  reference's functions run on the fake mesh with their
  ``NamedSharding`` replaced by its spec.  A port leaf is one layer: its
  spec is the JAX stacked leaf's without the leading layer dimension.
  The port has no ``constrain`` (no sequence-parallel residual);
- one ``make_train_step`` step on qwen3-1.7b SMOKE, 8 x 32 tokens, on
  ``make_debug_mesh`` 2 x 4 (the reference test's mesh) and 2 x 2,
  with f32 and int8 moments and with ``grad_accum`` 2, against the jitted
  JAX single-device step on the same params and batch: the loss and the
  global gradient norm within rel ``LOSS_REL`` and ``NORM_REL``, each
  gradient leaf within ``GRAD_SHARE`` of its largest magnitude (measured;
  ``_grad_bounds``), the params within ``2.02 lr``
  (an element whose first-step gradient is near 0 moves ``lr`` either
  way) and 99% of them within ``lr / 100``, everything under the
  reference test's 5e-2.  The heads, FFN hidden and logits run split over
  ``model`` where ``fit_spec`` keeps the split (2 KV heads do not split
  4 ways, so on 2 x 4 attention runs whole);
- on 4 x 2 (``d_model`` 64 over 4 data shards leaves 16 of a ``Q8``
  block of 32 a shard) the leaves whose blocks straddle shards update on
  the gathered leaf, and the step still matches;
- the same step and bounds on 2 x 2 with int8 moments for the RG-LRU
  width split over ``model`` (recurrentgemma SMOKE), the mLSTM/sLSTM
  layers (xlstm, whole) and the MoE (dbrx, one data group);
- elastic restore: xlstm-125m SMOKE params saved from a 4 x 2 mesh, plain
  and compressed, have the files of the unsharded save byte for byte and
  restore bit-equal onto 2 x 4 and onto one device.
"""
import copy
import filecmp
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import sharding as jsh
from repro.train import AdamWConfig as JAdamW, init_state as jinit
from repro.train.optimizer import apply_updates as japply
from repro.train.train_step import make_loss_fn as jloss_fn
from repro.train.train_step import make_train_step as jmake_step
from repro_torch import configs as pconfigs
from repro_torch import tree
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch.mesh import make_debug_mesh, train_grid
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models import sharding as psh
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.train import AdamWConfig, init_state, make_train_step
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as ts

ARCHS = jconfigs.all_arch_ids()
LOSS_REL = 1e-3
# the global gradient norm: the single-device step is off by up to
# 7.3e-4 of it here (xlstm), the 2 x 2 step by 1.4e-3 (xlstm)
NORM_REL = 3e-3
# a gradient leaf's largest difference from the JAX step's over its
# largest magnitude (``_grad_bounds``): the single-device step is held
# to 2e-2 on qwen3, xlstm and dbrx (``test_torch_train.py``), and is
# 0.0253 off on recurrentgemma's second ``conv_w`` at this batch (qwen3
# 0.0149, xlstm 0.0124, dbrx 0.0117); the sharded steps, their gradients
# summed in shard order and the column-parallel input gradients summed
# in f32 before their one rounding (ROADMAP §3), measure 0.0122 (qwen3
# 2 x 4), 0.0130 (qwen3 2 x 2 and 4 x 2), 0.0124 (xlstm), 0.0115 (dbrx)
# and 0.0275 (recurrentgemma, that ``conv_w``; 0.0248 with bf16 partials
# summed as autograd met them, ROADMAP §3)
GRAD_SHARE = 3e-2
CEILING = 5e-2


class FakeMesh:
    """Axis sizes only: what the rules read."""

    def __init__(self, **shape):
        self.shape = shape
        self.axis_names = tuple(shape)


@pytest.fixture
def jax_specs(monkeypatch):
    """The reference's rules on a ``FakeMesh``: its ``NamedSharding`` gives
    the spec itself, ``with_sharding_constraint`` returns it."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: s)
    prev = dict(jsh._CTX)
    yield
    jsh._CTX.update(prev)


def _spec(s) -> tuple:
    return tuple(s)


def _jax_leaf(jtree, cfg, path):
    """The JAX leaf (and whether it is stacked) that the port leaf at
    ``path`` is one layer of: layer ``i`` of ``blocks`` is prefix ``i`` or
    cycle position ``c`` of the JAX ``blocks``."""
    if path[0] != "blocks":
        node = jtree
        for k in path:
            node = node[k]
        return node, False
    n_prefix, n_cycle = len(cfg.prefix_pattern), len(cfg.cycle)
    layer = path[1]
    node, stacked = ((jtree["prefix"][layer], False) if layer < n_prefix
                     else (jtree["blocks"][(layer - n_prefix) % n_cycle],
                           True))
    for k in path[2:]:
        node = node[k]
    return node, stacked


def _walk(t, path=()):
    if isinstance(t, dict):
        for k in sorted(t):
            yield from _walk(t[k], path + (k,))
    elif isinstance(t, (list, tuple)):
        for i, v in enumerate(t):
            yield from _walk(v, path + (i,))
    else:
        yield path, t


def _trees(arch, full):
    cj = (jconfigs.get_config if full else jconfigs.get_smoke_config)(arch)
    cp = (pconfigs.get_config if full else pconfigs.get_smoke_config)(arch)
    jp = jax.eval_shape(lambda: JM.init_params(cj, jax.random.PRNGKey(0)))
    return cj, cp, jp, PM.init_params(cp, torch.Generator(), "meta")


def _check_params(cp, jp, pp, mesh, moe_ep=False):
    jsh.set_mesh_context(mesh if moe_ep else None, moe_ep=moe_ep)
    want = jsh.param_shardings(mesh, jp)
    with psh.mesh_context(mesh, moe_ep=moe_ep):
        got = psh.param_shardings(mesh, pp)
    n = 0
    for path, ns in _walk(got):
        w, stacked = _jax_leaf(want, cp, path)
        w = _spec(w)
        assert ns.spec == (w[1:] if stacked else w), path
        n += 1
    return n


@pytest.mark.parametrize("full", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shardings_equal_the_reference(arch, full, jax_specs):
    cj, cp, jp, pp = _trees(arch, full)
    n_leaves = len(tree.leaves(pp))
    for mesh in (FakeMesh(data=16, model=16),
                 FakeMesh(pod=2, data=16, model=16)):
        assert _check_params(cp, jp, pp, mesh) == n_leaves
    if cp.num_experts:
        assert _check_params(cp, jp, pp, FakeMesh(data=16, model=16),
                             moe_ep=True) == n_leaves
        # the variant moves the experts' E over the data axes
        with psh.mesh_context(FakeMesh(data=16, model=16), moe_ep=True):
            sp = psh.param_shardings(FakeMesh(data=16, model=16), pp)
        layer = len(cp.prefix_pattern)
        assert sp["blocks"][layer]["ffn"]["wi"].spec[0] in ("data", None)


@pytest.mark.parametrize("arch", [a for a in ARCHS if a != "hubert-xlarge"])
def test_cache_shardings_equal_the_reference(arch, jax_specs):
    """Decode caches at batch 32, 64 positions on 16 x 16 and 4 x 2: the
    KV heads over ``model`` where they divide, else the sequence."""
    cj, cp = jconfigs.get_smoke_config(arch), pconfigs.get_smoke_config(arch)
    jc = jax.eval_shape(lambda: JM.init_cache(cj, 32, 64))
    pc = PM.init_cache(cp, 32, 64, device="meta")
    for mesh in (FakeMesh(data=16, model=16), FakeMesh(data=4, model=2)):
        want = jsh.cache_shardings(mesh, jc)
        got = psh.cache_shardings(mesh, pc)
        n = 0
        for (layer, *rest), ns in _walk(got):
            w, stacked = _jax_leaf(want, cp, ("blocks", layer, *rest))
            w = _spec(w)
            assert ns.spec == (w[1:] if stacked else w), (layer, rest)
            n += 1
        assert n == len(tree.leaves(pc))


def test_batch_rules_and_constrain(jax_specs):
    """``batch_shardings`` (a batch that does not divide among them) and
    ``logits_sharding`` equal the reference's; ``mesh_context`` installs
    its ``moe_ep`` option and restores the one before.  The reference's
    ``activation_constraint``, ``constrain`` and ``seq_shard`` have no
    counterpart (``models/sharding.py``'s docstring)."""
    batch = {"tokens": np.zeros((8, 32), np.int32),
             "patch_embeds": np.zeros((8, 4, 16), np.float32),
             "odd": np.zeros((3, 5), np.int32), "scalar": np.zeros(())}
    for mesh in (FakeMesh(data=4, model=2), FakeMesh(pod=2, data=2,
                                                     model=4)):
        want = jsh.batch_shardings(mesh, batch)
        got = psh.batch_shardings(mesh, batch)
        for k in batch:
            assert got[k].spec == _spec(want[k]), k
        assert psh.logits_sharding(mesh).spec == _spec(
            jsh.logits_sharding(mesh))
        with psh.mesh_context(mesh, moe_ep=True):
            assert psh._CTX == {"mesh": mesh, "moe_ep": True}
        assert psh._CTX == {"mesh": None, "moe_ep": False}


# ------------------------------------------------------- the sharded step
@functools.lru_cache(maxsize=None)
def _arch(arch):
    cj = jconfigs.get_smoke_config(arch)
    cp = pconfigs.get_smoke_config(arch)
    params = jax.jit(JM.init_params, static_argnums=0)(
        cj, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cj.vocab_size, (8, 32))
    return cj, cp, params, toks


@functools.lru_cache(maxsize=None)
def _jax_step(arch, state_dtype, grad_accum):
    """The reference test's single-device step (``jax.jit(step)``), and at
    ``grad_accum`` 1 its gradients: there the step is
    ``value_and_grad`` then ``apply_updates`` (``make_train_step``
    :40-63), jitted as those two parts."""
    cj, _, params, toks = _arch(arch)
    ocfg = JAdamW(lr=1e-3, state_dtype=state_dtype)
    jb = {"tokens": jnp.asarray(toks)}
    if grad_accum == 1:
        loss, grads = jax.jit(jax.value_and_grad(jloss_fn(cj)))(params, jb)
        p1, _, m1 = jax.jit(functools.partial(japply, ocfg))(
            params, grads, jinit(ocfg, params))
        m1["loss"] = loss
    else:
        grads = None
        p1, _, m1 = jax.jit(jmake_step(cj, ocfg, grad_accum=grad_accum))(
            params, jinit(ocfg, params), jb)
    return (jax.tree.map(np.array, p1), float(m1["loss"]),
            float(m1["grad_norm"]), float(m1["lr"]),
            None if grads is None else jax.tree.map(np.array, grads))


def _on_mesh(cfg, params, batch, mesh):
    return (psh.place_tree(params, psh.param_shardings(mesh, params)),
            psh.place_tree(batch, psh.batch_shardings(mesh, batch)))


def _param_bounds(got: dict, want, lr: float, cfg):
    diffs = np.concatenate([
        np.abs(a - b).reshape(-1) for a, b in zip(
            jax.tree.leaves(params_to_numpy(cfg, got)),
            jax.tree.leaves(want))])
    assert diffs.max() <= min(2.02 * lr, CEILING)
    assert np.mean(diffs <= lr / 100) >= 0.99


def _count_sites(monkeypatch):
    """Counts of ``tp_site`` calls that ran split (``ModelShards``) by the
    layer function's name, and the logits' vocabulary blocks a call."""
    seen = {"split": {}, "whole": {}, "logit_parts": []}
    tp, heads = pm.tp_site, PM._head_parts

    def site(fn, p, *a, **kw):
        key = "split" if isinstance(p, pm.ModelShards) else "whole"
        seen[key][fn.__name__] = seen[key].get(fn.__name__, 0) + 1
        return tp(fn, p, *a, **kw)

    def head(*a):
        out = heads(*a)
        seen["logit_parts"].append(len(out))
        return out
    monkeypatch.setattr(pm, "tp_site", site)
    monkeypatch.setattr(PM, "_head_parts", head)
    return seen


def _mesh_grads(cfg, g):
    """The sharded step's gradients (``train_step.grads``, as the step at
    ``grad_accum`` 1 takes them), gathered to the JAX tree's leaves."""
    return jax.tree.leaves(params_to_numpy(cfg, psh.gather_tree(g)))


def _keep_grads(monkeypatch) -> list:
    """The gradients each ``train_step.grads`` call of the step returns,
    kept as the step takes them."""
    kept, grads = [], ts.grads

    def keep(*a, **kw):
        out = grads(*a, **kw)
        kept.append(out[1])
        return out
    monkeypatch.setattr(ts, "grads", keep)
    return kept


def _grad_bounds(got, jgrads, eps: float):
    """Each gradient leaf within ``GRAD_SHARE`` of its largest magnitude,
    or of AdamW's ``eps`` where that is larger: below ``eps`` the first
    step moves a param by ``lr g / eps``, so a difference of
    ``GRAD_SHARE eps`` moves it by ``GRAD_SHARE lr`` at most.  (The
    RG-LRU decay's ``a_param`` and ``w_a_gate`` get gradients of about
    1e-11: the decay ``exp(-8 r softplus(a_param))`` is about 1e-12 at
    init, and their products round differently in every order.)  Every
    leaf, those too, also within ``CEILING`` of its own norm (0.0309
    measured, ``a_param``; the single-device step 0.0296)."""
    for (path, want), g in zip(
            jax.tree_util.tree_leaves_with_path(jgrads), got):
        key = jax.tree_util.keystr(path)
        assert g.shape == want.shape, key
        share = np.abs(g - want).max() / max(np.abs(want).max(), eps)
        assert share <= GRAD_SHARE, key
        assert np.linalg.norm(g - want) <= CEILING * np.linalg.norm(want), \
            key


def _sharded_step(arch, shape, state_dtype, grad_accum, monkeypatch):
    """One sharded step of ``arch`` SMOKE on ``make_debug_mesh(*shape)``
    held against the JAX single-device step: loss, gradient norm, lr,
    params, layout and (``grad_accum`` 1) every gradient leaf.  Returns
    the ``tp_site`` counts, the placed params and the single-device
    tree."""
    cj, cp, params, toks = _arch(arch)
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    jp1, jloss, jnorm, lr, jgrads = _jax_step(arch, state_dtype, grad_accum)
    mesh = make_debug_mesh(*shape, device="cpu")
    ps, bs = _on_mesh(cp, tp, {"tokens": torch.from_numpy(toks)}, mesh)
    ocfg = AdamWConfig(lr=1e-3, state_dtype=state_dtype)
    seen = _count_sites(monkeypatch)
    kept = _keep_grads(monkeypatch)
    with psh.mesh_context(mesh):
        st = init_state(ocfg, ps)
        p1, s1, m1 = make_train_step(cp, ocfg, grad_accum=grad_accum)(
            ps, st, bs)
    seen = copy.deepcopy(seen)          # the step's sites alone
    assert float(m1["loss"]) == pytest.approx(jloss, rel=LOSS_REL)
    assert abs(float(m1["loss"]) - jloss) < CEILING
    assert float(m1["grad_norm"]) == pytest.approx(jnorm, rel=NORM_REL)
    assert float(m1["lr"]) == lr
    _param_bounds(psh.gather_tree(p1), jp1, lr, cp)
    # the step returns params and state in their layout
    for x, y in zip(tree.leaves(p1), tree.leaves(ps)):
        assert isinstance(x, psh.Sharded) and x.sharding.spec == y.spec
    mom = tree.leaves(s1["m"], is_leaf=lambda x: isinstance(x, opt.Q8))
    assert all(isinstance(x, opt.Q8) == (state_dtype == "int8")
               for x in mom)
    assert int(s1["step"].gather()) == 1
    if grad_accum == 1:
        _grad_bounds(_mesh_grads(cp, kept[0]), jgrads, ocfg.eps)
    return seen, ps, tp


@pytest.mark.parametrize("shape,state_dtype,grad_accum", [
    ((2, 4), "float32", 1), ((2, 4), "int8", 1), ((2, 2), "float32", 1),
    ((2, 2), "int8", 1), ((2, 4), "float32", 2), ((2, 2), "int8", 2)])
def test_sharded_step_matches_jax(shape, state_dtype, grad_accum,
                                  monkeypatch):
    seen, _, _ = _sharded_step("qwen3-1.7b", shape, state_dtype,
                               grad_accum, monkeypatch)
    # the split sites: 2 layers a microbatch a data shard
    calls = 2 * grad_accum * shape[0]
    split_attn = shape[1] == 2             # 2 KV heads over 2, not over 4
    assert seen["split"].get("attention_full", 0) == \
        (calls if split_attn else 0)
    assert seen["whole"].get("attention_full", 0) == \
        (0 if split_attn else calls)
    assert seen["split"]["mlp"] == calls
    assert set(seen["logit_parts"]) == {shape[1]}


def test_q8_blocks_straddling_shards_update_gathered(monkeypatch):
    """4 x 2: ``d_model`` 64 over 4 data shards is 16 a shard, half a
    ``Q8`` block, on the last axis of ``embed``, ``wo`` and ``w_down``:
    those leaves update on the gathered leaf (their scales held whole
    over the last axis) and the step matches the JAX step."""
    cj, cp, params, toks = _arch("qwen3-1.7b")
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    jp1, jloss, _, lr, _ = _jax_step("qwen3-1.7b", "int8", 1)
    mesh = make_debug_mesh(4, 2, device="cpu")
    ps, bs = _on_mesh(cp, tp, {"tokens": torch.from_numpy(toks)}, mesh)
    straddle = {psh._path_str(p) for p, x in _walk(ps)
                if not opt._q8_aligned(x)}
    assert straddle == {"embed"} | {
        f"blocks/{i}/{k}" for i in range(2)
        for k in ("inner/wo", "ffn/w_down")}
    gathered = []
    adamw = opt._adamw

    def spy(cfg, p, *a):
        gathered.append(tuple(p.shape))
        return adamw(cfg, p, *a)
    monkeypatch.setattr(opt, "_adamw", spy)
    ocfg = AdamWConfig(lr=1e-3, state_dtype="int8")
    p1, s1, m1 = make_train_step(cp, ocfg)(ps, init_state(ocfg, ps), bs)
    whole = {tuple(tp["embed"].shape), (4, 16, 64), (128, 64)}
    assert whole <= set(gathered)
    assert s1["m"]["embed"].scale.spec == ("model", None)
    assert float(m1["loss"]) == pytest.approx(jloss, rel=LOSS_REL)
    _param_bounds(psh.gather_tree(p1), jp1, lr, cp)


def test_gradient_sums_run_in_shard_order():
    """A block that several data groups and model shards read gets the
    shard-order sum (``psum``, in read order) of its reads' gradients,
    each taken alone by a backward pass of its own, never autograd's
    accumulation across devices; a second run is bit-equal.
    qwen3 SMOKE (tied embedding) on 2 x 2: each block of ``embed`` is
    read by both data groups' embeddings and their vocabulary-parallel
    heads."""
    cj, cp, params, toks = _arch("qwen3-1.7b")
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    mesh = make_debug_mesh(2, 2, device="cpu")
    ps, bs = _on_mesh(cp, tp, {"tokens": torch.from_numpy(toks)}, mesh)
    grid = [[mesh.devices[i] for i in row] for row in train_grid(mesh)]
    rows = ts._rows(bs, grid)
    runs = []
    for _ in range(2):
        loss, g = ts.sharded_value_and_grad(cp, ps, rows, grid)
        runs.append((loss, tree.leaves(g)))
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2)
    for a, b in zip(grads, grads2):
        assert all(torch.equal(a.blocks[i], b.blocks[i]) for i in a.blocks)
    # every read of each block alone, in the forward's read order
    flat, spec = tree.flatten(ps)
    taps = [ts._Reads(x) for x in flat]
    loss3 = PM.sharded_loss(cp, tree.unflatten(spec, taps), rows, grid)
    assert torch.equal(loss3.detach(), loss)
    checked = 0
    for k, t in enumerate(taps):
        by_owner: dict = {}
        for i, leaf in t.reads:
            by_owner.setdefault(i, []).append(leaf)
        for i, leaves in by_owner.items():
            if len(leaves) < 3:
                continue
            alone = [torch.autograd.grad(loss3, [leaf], retain_graph=True,
                                         allow_unused=True)[0]
                     for leaf in leaves]
            want = psh.psum([a for a in alone if a is not None],
                            t.blocks[i].device)
            assert torch.equal(grads[k].blocks[i], want)
            checked += 1
    assert checked >= 4          # the four blocks of ``embed``


def test_sharded_step_frees_its_trees_without_the_cycle_collector(
        monkeypatch):
    """A train step on 2 x 2 leaves no reference cycle behind, so its
    trees (the reads' copies of every block among their leaves) are freed
    as it returns.  ``tree.flatten``/``unflatten`` recursed through
    nested functions, each a cycle with its closure cell that held the
    leaves until the cyclic collector ran: on four cards the lead card
    carried the previous step's gathered weights into the next step."""
    import gc
    import weakref
    cj, cp, params, toks = _arch("qwen3-1.7b")
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    mesh = make_debug_mesh(2, 2, device="cpu")
    ps, bs = _on_mesh(cp, tp, {"tokens": torch.from_numpy(toks)}, mesh)
    ocfg = AdamWConfig(state_dtype="int8")
    step = make_train_step(cp, ocfg)
    st = init_state(ocfg, ps)
    reads: list = []
    assemble = ts._Reads.assemble

    def spy(self, device, owners):
        out = assemble(self, device, owners)
        reads.extend(weakref.ref(leaf) for _, leaf in self.reads[-1:])
        return out
    monkeypatch.setattr(ts._Reads, "assemble", spy)
    gc.collect()
    gc.disable()
    try:
        with psh.mesh_context(mesh):
            ps, st, _ = step(ps, st, bs)
        assert reads and all(r() is None for r in reads)
        assert gc.collect() == 0
    finally:
        gc.enable()


def test_column_parallel_input_gradients_round_once():
    """The gradient of a column-parallel site's input (the
    vocabulary-parallel head's here) is the model shards' f32 partials
    summed in shard order and rounded once, as one device rounds its
    whole product once.  qwen3 SMOKE on 1 x 2 against the port on one
    device: ``final_norm``'s gradient, which the head's input gradient
    alone feeds, within 2e-4 of its largest magnitude (4.3e-5 measured;
    1.5e-3 with each shard's partial rounded to bf16 before the sum)."""
    cj, cp, params, toks = _arch("qwen3-1.7b")
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    batch = {"tokens": torch.from_numpy(toks)}
    _, one = ts.grads(cp, tp, batch)
    ps, bs = _on_mesh(cp, tp, batch, make_debug_mesh(1, 2, device="cpu"))
    _, got = ts.grads(cp, ps, bs)
    a = got["final_norm"].gather()
    b = one["final_norm"]
    assert float((a - b).abs().max() / b.abs().max()) <= 2e-4


def test_row_parallel_outputs_are_one_product():
    """A tensor-parallel site's row-parallel projection (attention's
    ``wo``, the FFN's ``w_down``) is one product on the lead device, from
    the model shards' inputs gathered there, as one device takes it: the
    residual after the layers of qwen3 SMOKE on 1 x 2 equals one
    device's bit for bit.  Partial products summed over the shards, even
    in f32, part from it in the last bits (on the card they held the mesh
    step's share of params within lr / 100 at 0.9574, against 0.9837 with
    one product and the one-device control's 0.9838)."""
    cj, cp, params, toks = _arch("qwen3-1.7b")
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    mesh = make_debug_mesh(1, 2, device="cpu")
    ps = psh.place_tree(tp, psh.param_shardings(mesh, tp))
    with torch.no_grad():
        h = PM.embed_inputs(cp, tp, torch.from_numpy(toks))
        one, _, _ = PM._layers(cp, tp, h, collect_cache=False, remat=False)
        devs = [mesh.devices[0, j] for j in range(2)]
        view = {"blocks": PM._LayerViews(cp, ps["blocks"], devs, devs[0])}
        got, _, _ = PM._layers(cp, view, h, collect_cache=False,
                               remat=False)
    assert torch.equal(got, one)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "xlstm-125m",
                                  "dbrx-132b"])
def test_sharded_step_matches_jax_across_archs(arch, monkeypatch):
    """2 x 2, int8 moments, against the JAX single-device step as above
    (loss, gradient norm, every gradient leaf, params): the RG-LRU width
    split over ``model``, the mLSTM/sLSTM layers whole, the MoE in one
    data group; every device holds less than the whole tree."""
    seen, ps, tp = _sharded_step(arch, (2, 2), "int8", 1, monkeypatch)
    if arch == "recurrentgemma-9b":
        assert seen["split"]["recurrent_full"] > 0
    total = sum(x.numel() * x.element_size() for x in tree.leaves(tp))
    per = psh.device_bytes(ps)
    assert len(per) == 4 and max(per.values()) < total


# -------------------------------------------------------- elastic restore
@pytest.fixture(scope="module")
def xlstm_saves(tmp_path_factory):
    """xlstm SMOKE params and their unsharded saves, plain and
    compressed."""
    cp = pconfigs.get_smoke_config("xlstm-125m")
    params = PM.init_params(cp, torch.Generator().manual_seed(0), "cpu")
    dirs = {}
    for compress in (False, True):
        d = tmp_path_factory.mktemp(f"single_{compress}")
        ckpt.save(d, 1, params, compress=compress, device="cpu")
        dirs[compress] = d
    return params, dirs


@pytest.mark.parametrize("compress", [False, True])
def test_elastic_restore_across_meshes(xlstm_saves, compress, tmp_path):
    params, dirs = xlstm_saves
    m1 = make_debug_mesh(4, 2, device="cpu")
    ckpt.save(tmp_path, 1, psh.place_tree(params,
                                          psh.param_shardings(m1, params)),
              compress=compress, device="cpu")
    a, b = dirs[compress] / "step_00000001", tmp_path / "step_00000001"
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and len(names) > 3
    for n in names:
        assert filecmp.cmp(a / n, b / n, shallow=False), n
    m2 = make_debug_mesh(2, 4, device="cpu")
    sh2 = psh.param_shardings(m2, params)
    back, _, step = ckpt.restore(tmp_path, shardings=sh2)
    assert step == 1
    one, _, _ = ckpt.restore(tmp_path, device="cpu")
    for x, y, z, s in zip(tree.leaves(params), tree.leaves(back),
                          tree.leaves(one), tree.leaves(sh2)):
        assert isinstance(y, psh.Sharded) and y.spec == s.spec
        assert torch.equal(y.gather(), x) and torch.equal(z, x)
        assert x.dtype == y.gather().dtype == z.dtype

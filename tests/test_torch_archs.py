"""The remaining transformer architectures in the port against the JAX
package, at SMOKE width on the CPU: minitron-4b/8b (squared-ReLU MLP,
untied head), command-r-plus-104b (parallel attention and FFN),
paligemma-3b (the vision stub frontend, ``patch_embeds``, and the gemma
scale), hubert-xlarge (the audio stub frontend, ``frame_embeds``, and a
bidirectional encoder), dbrx-132b and kimi-k2-1t-a32b (top-k MoE with
capacity dropping; kimi with a shared expert and a dense prefix layer).

Held as ``tests/test_archs.py`` holds the JAX package, each against the
compiled JAX model on the same converted params:

- forward logits within 0.05 absolute with the same argmax (the bound of
  ``test_torch_model.py``: both sides round to bf16 at the same points;
  XLA's and PyTorch's CPU reductions, ``rsqrt`` and ``exp`` can part in
  the last f32 bit, which the bf16 residual stream carries to the logits
  as about one bf16 step);
- the port's ``decode_step`` against its own ``forward`` at the
  reference's 2e-2 (MoE at a no-drop capacity, as the reference's test);
- ``exact_param_count`` equal to the JAX package's on every full config,
  with nothing allocated (the ``meta`` device);
- ``moe`` bit for bit against ``repro.models.modules.moe`` where the
  capacity drops choices, over two dispatch groups, with a shared expert.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import model as JM
from repro.models import modules as jm
from repro_torch import configs as pconfigs
from repro_torch.kernels import fused_page_attention as fpa
from repro_torch.models import model as PM
from repro_torch.models import modules as pm
from repro_torch.models.convert import params_from_numpy

ATOL = 0.05
NEW_ARCHS = ("minitron-4b", "minitron-8b", "command-r-plus-104b",
             "paligemma-3b", "hubert-xlarge", "dbrx-132b", "kimi-k2-1t-a32b")
SERVED = jconfigs.all_arch_ids()


@functools.lru_cache(maxsize=None)
def _jax_params(cj):
    return jax.jit(JM.init_params, static_argnums=0)(cj,
                                                     jax.random.PRNGKey(0))


def _pair(arch, **kw):
    cj = dataclasses.replace(jconfigs.get_smoke_config(arch), **kw)
    cp = dataclasses.replace(pconfigs.get_smoke_config(arch), **kw)
    params = _jax_params(cj)
    tp = params_from_numpy(cp, jax.tree.map(np.array, params), "cpu")
    return cj, cp, params, tp


def _inputs(cfg, b=2, s=32, seed=0):
    """The reference test's batch (``tests/test_archs.py::make_batch``) as
    (JAX batch, port tokens, port keyword tensors)."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        fe = rng.normal(0, 1, (b, s, cfg.d_model)).astype(np.float32)
        return ({"frame_embeds": jnp.asarray(fe)}, None,
                {"frame_embeds": torch.from_numpy(fe)})
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    batch, kw = {"tokens": jnp.asarray(toks)}, {}
    if cfg.frontend == "vision":
        pe = rng.normal(0, 1, (b, 8, cfg.d_model)).astype(np.float32)
        batch["patch_embeds"] = jnp.asarray(pe)
        kw["patch_embeds"] = torch.from_numpy(pe)
    return batch, torch.from_numpy(toks), kw


@pytest.fixture(scope="module", params=NEW_ARCHS)
def arch(request):
    cj, cp, params, tp = _pair(request.param)
    return dict(name=request.param, cj=cj, cp=cp, params=params, tp=tp)


def test_forward_logits_match_jax(arch):
    """Prefill logits of the whole sequence (with the image prefix for
    paligemma, from frames for hubert) within 0.05 and the same argmax;
    finite and of the reference's shape."""
    cj, cp = arch["cj"], arch["cp"]
    batch, toks, kw = _inputs(cj)
    jl = np.asarray(jax.jit(lambda p, bt: JM.forward(
        cj, p, bt, remat=False)[0])(arch["params"], batch))
    pl, caches = PM.forward(cp, PM.serving_params(arch["tp"]), toks, **kw)
    s_extra = 8 if cp.frontend == "vision" else 0
    assert pl.shape == (2, 32 + s_extra, cp.vocab_size) == jl.shape
    assert torch.isfinite(pl).all()
    assert len(caches) == cp.num_layers
    np.testing.assert_allclose(pl.numpy(), jl, atol=ATOL)
    assert np.array_equal(pl.argmax(-1).numpy(), jl.argmax(-1))


@pytest.mark.parametrize("name", [a for a in NEW_ARCHS
                                  if a != "hubert-xlarge"])
def test_decode_matches_forward(name):
    """Greedy per-position logits of the port's dense-cache
    ``decode_step`` equal its ``forward``'s within the reference's 2e-2
    (``test_decode_matches_forward``): pure-text input for paligemma, a
    no-drop capacity (cap == group) for the MoE configs."""
    kw = {}
    base = pconfigs.get_smoke_config(name)
    if base.num_experts:
        kw["capacity_factor"] = float(base.num_experts
                                      / base.num_experts_per_tok)
    _, cp, _, tp = _pair(name, **kw)
    tp = PM.serving_params(tp)
    b, s = 2, 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cp.vocab_size, (b, s)))
    full, _ = PM.forward(cp, tp, toks)
    cache = PM.init_cache(cp, b, s, device="cpu")
    outs = []
    for t in range(s):
        lg, cache = PM.decode_step(cp, tp, cache, toks[:, t:t + 1],
                                   torch.full((b,), t))
        outs.append(lg[:, 0])
    torch.testing.assert_close(torch.stack(outs, 1), full, rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("name", SERVED)
def test_exact_param_count_matches_jax(name):
    """``exact_param_count`` of every full config the port serves equals
    the JAX package's (kimi-k2's 1.03 T included), built on the ``meta``
    device: no tensor is allocated.  The analytic ``param_count()`` lands
    within 1% of it, but for xlstm-125m, whose internals it approximates
    (the reference's ``exact_param_count`` docstring)."""
    got = PM.exact_param_count(pconfigs.get_config(name))
    assert got == JM.exact_param_count(jconfigs.get_config(name))
    if name != "xlstm-125m":
        assert abs(got - pconfigs.get_config(name).param_count()) \
            <= 0.01 * got


@pytest.mark.parametrize("name", SERVED)
def test_full_config_param_count(name):
    """The port's full configs are the JAX package's, field for field, and
    land near the nameplates (``test_full_config_param_count``)."""
    nameplate = {
        "qwen3-1.7b": 1.7e9, "minitron-4b": 4.2e9, "minitron-8b": 7.7e9,
        "command-r-plus-104b": 104e9, "hubert-xlarge": 0.96e9,
        "paligemma-3b": 2.5e9, "dbrx-132b": 132e9,
        "kimi-k2-1t-a32b": 1.03e12, "recurrentgemma-9b": 8.5e9,
        "xlstm-125m": 0.125e9}[name]
    cfg = pconfigs.get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jconfigs.get_config(name))
    assert abs(cfg.param_count() - nameplate) / nameplate < 0.30


def test_moe_active_params():
    """``test_moe_active_params``'s bounds on the port's configs."""
    kimi = pconfigs.get_config("kimi-k2-1t-a32b")
    assert abs(kimi.active_param_count() - 33e9) / 33e9 < 0.15
    dbrx = pconfigs.get_config("dbrx-132b")
    assert abs(dbrx.active_param_count() - 36e9) / 36e9 < 0.15


def test_encoder_is_bidirectional():
    """hubert-xlarge forwards without a causal mask
    (``test_encoder_is_bidirectional``): perturbing the last frame moves
    the first frame's logits."""
    _, cp, _, tp = _pair("hubert-xlarge")
    tp = PM.serving_params(tp)
    rng = np.random.default_rng(3)
    fe = rng.normal(0, 1, (1, 16, cp.d_model)).astype(np.float32)
    fe2 = fe.copy()
    fe2[0, -1] += 10.0
    l1, _ = PM.forward(cp, tp, frame_embeds=torch.from_numpy(fe))
    l2, _ = PM.forward(cp, tp, frame_embeds=torch.from_numpy(fe2))
    assert not torch.allclose(l1[0, 0], l2[0, 0])
    causal = dataclasses.replace(cp, causal=True)
    c1, _ = PM.forward(causal, tp, frame_embeds=torch.from_numpy(fe))
    c2, _ = PM.forward(causal, tp, frame_embeds=torch.from_numpy(fe2))
    assert torch.equal(c1[0, 0], c2[0, 0])


@pytest.mark.parametrize("name,shape", [("dbrx-132b", (2, 550)),
                                        ("kimi-k2-1t-a32b", (2, 40))])
def test_moe_bitwise_with_drops(name, shape):
    """``modules.moe`` bit for bit against the JAX package's ``moe`` on the
    same bf16 activations and converted params, at capacity factor 0.5 so
    that choices are dropped: dbrx SMOKE over two dispatch groups (1100
    tokens, groups of 550, capacity 138), kimi SMOKE with its shared
    expert (one group of 80, capacity 10, the floor of 4 not binding)."""
    cj, cp, params, tp = _pair(name, capacity_factor=0.5)
    layer = len(cj.prefix_pattern)          # the first routed layer
    jp = jax.tree.map(lambda x: x[0], params["blocks"][0]["ffn"])
    pp = PM.serving_params(tp)["blocks"][layer]["ffn"]
    assert set(pp) == set(jp) and ("shared" in pp) == bool(
        cj.n_shared_experts)
    rng = np.random.default_rng(7)
    x = jnp.asarray(rng.normal(0, 1, (*shape, cj.d_model)),
                    jnp.float32).astype(jnp.bfloat16)
    want, want_aux = jax.jit(lambda p, a: jm.moe(p, a, cj))(jp, x)
    xp = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    got, aux = pm.moe(pp, xp, cp)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.float(), torch.from_numpy(
        np.array(want.astype(jnp.float32))))
    # the training losses: the same routing, so equal up to the last bits
    # of the f32 means and logsumexp
    for k in ("load_balance", "router_z"):
        np.testing.assert_allclose(aux[k].item(), float(want_aux[k]),
                                   rtol=1e-6)
    # the routing dropped choices, and every kept one sits in [0, cap)
    g, cap = pm.moe_capacity(cp, shape[0] * shape[1])
    logits = torch.matmul(xp.float().reshape(-1, g, cp.d_model),
                          pp["router"])
    combine, sel = pm.moe_route(logits, cp.num_experts_per_tok, cap)
    kept = int((combine > 0).sum())
    assert 0 < kept < sel.numel()
    per_expert = (combine > 0).any(-1).sum(1)           # [N, E] tokens kept
    assert int(per_expert.amax()) == cap


def test_heads_per_block():
    """Kernel 3's head split: pages of at most 4096 query-head values keep
    one block (qwen3, recurrentgemma, minitron); dbrx and kimi split their
    8 KV heads in 2 blocks, command-r-plus in 4; a single KV head's group
    past the limit is refused."""
    assert fpa.heads_per_block(16, 8, 128) == 8
    assert fpa.heads_per_block(16, 1, 256) == 1
    assert fpa.heads_per_block(32, 8, 128) == 8
    assert fpa.heads_per_block(48, 8, 128) == 4
    assert fpa.heads_per_block(64, 8, 112) == 4
    assert fpa.heads_per_block(96, 8, 128) == 2
    with pytest.raises(ValueError, match="query heads"):
        fpa.heads_per_block(64, 1, 128)


def test_refusals_name_their_item():
    """xlstm-125m builds (its mLSTM and sLSTM kinds are ported), an
    unknown layer kind is refused naming the kinds there are; an encoder
    is refused by every decode entry point with a clear error, and
    forwards."""
    PM.check_supported(pconfigs.get_config("xlstm-125m"))
    with pytest.raises(ValueError, match="unknown layer kinds"):
        PM.check_supported(dataclasses.replace(
            pconfigs.get_smoke_config("qwen3-1.7b"),
            block_pattern=("global", "conv")))
    assert pconfigs.all_arch_ids() == jconfigs.all_arch_ids()
    cfg = pconfigs.get_smoke_config("hubert-xlarge")
    for build in (lambda: PM.PagedKVCache(cfg, 8, device="cpu"),
                  lambda: PM.init_cache(cfg, 1, 8, device="cpu")):
        with pytest.raises(ValueError, match="encoder"):
            build()


def test_params_carry_every_tree():
    """``params_from_numpy`` carries the untied head and MoE trees (the f32
    router, the expert stacks, the shared expert, kimi's dense prefix
    layer), and the port's own init draws the same shapes and dtypes."""
    for name in ("minitron-8b", "kimi-k2-1t-a32b"):
        cj, cp, params, tp = _pair(name)
        own = PM.init_params(cp, torch.Generator().manual_seed(0), "cpu")
        assert own.keys() == tp.keys()
        for a, b in zip(own["blocks"], tp["blocks"]):
            fa, fb = a["ffn"], b["ffn"]
            assert fa.keys() == fb.keys()
            for k in fa:
                if isinstance(fa[k], dict):
                    continue
                assert fa[k].shape == fb[k].shape and \
                    fa[k].dtype == fb[k].dtype, k
        if "unembed" in params:
            np.testing.assert_array_equal(tp["unembed"].numpy(),
                                          np.asarray(params["unembed"]))
        else:
            ffn = tp["blocks"][1]["ffn"]
            assert ffn["router"].dtype == torch.float32
            np.testing.assert_array_equal(
                ffn["shared"]["w_gate"].numpy(),
                np.asarray(params["blocks"][0]["ffn"]["shared"]["w_gate"][0]))
            assert "router" not in tp["blocks"][0]["ffn"]

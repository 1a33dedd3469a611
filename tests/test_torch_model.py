"""Port model vs the JAX package on qwen3-1.7b SMOKE with the same
converted params: the conversion itself and the prefill logits and caches
(exact-bucket and padded prompts).  The paged decode steps are held against
the reference in ``test_torch_engine.py``, where both engines run in
lockstep.

Tolerance: logits within 0.05 absolute with the same argmax.  Both sides
round to bf16 at the same points and agree bit for bit on this CPU; the
bound leaves room for a last-bit difference in a transcendental (cos/sin
in rope) between XLA's and PyTorch's CPU libraries, which the bf16
residual stream carries to the logits as about one bf16 step (1/64 at
|logit| in [2, 4)).  The int8 prefill caches, which decide the KV bytes,
must be identical."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as PM
from repro_torch.models.convert import params_from_numpy

ATOL = 0.05


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jconfigs.get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    cfg_p = dataclasses.replace(get_smoke_config("qwen3-1.7b"),
                                kv_cache_dtype="apack-int8")
    params = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.array, params)
    return cfg_j, cfg_p, params, tree, params_from_numpy(cfg_p, tree, "cpu")


def test_params_from_numpy_round_trip(setup):
    cfg_j, cfg_p, _, tree, tp = setup
    assert len(tp["blocks"]) == cfg_p.num_layers
    np.testing.assert_array_equal(tp["embed"].numpy(), tree["embed"])
    stack = tree["blocks"][0]
    for layer, blk in enumerate(tp["blocks"]):
        for path in (("norm1",), ("inner", "wq"), ("inner", "wo"),
                     ("inner", "k_norm"), ("ffn", "w_gate"),
                     ("ffn", "w_down")):
            want, got = stack, blk
            for k in path:
                want, got = want[k], got[k]
            np.testing.assert_array_equal(got.numpy(), want[layer])
    # the port's own init draws the same shapes and scales
    own = PM.init_params(cfg_p, torch.Generator().manual_seed(0), "cpu")
    assert own["embed"].shape == tp["embed"].shape
    assert own["blocks"][0]["inner"]["wo"].shape == \
        tp["blocks"][0]["inner"]["wo"].shape
    std = own["blocks"][0]["ffn"]["w_down"].std().item()
    assert abs(std - cfg_p.d_ff ** -0.5) < 0.1 * cfg_p.d_ff ** -0.5


@pytest.mark.parametrize("n", [16, 11])
def test_prefill_logits_and_caches_match(setup, n):
    """n=16 lands exactly on its bucket; n=11 is padded to 16 and masked
    by ``true_len`` on both sides."""
    cfg_j, cfg_p, params, _, tp = setup
    toks = np.random.default_rng(n).integers(0, cfg_p.vocab_size, n)
    padded = np.zeros((1, 16), np.int32)
    padded[0, :n] = toks
    fwd = jax.jit(lambda p, t, tl: JM.forward(
        cfg_j, p, {"tokens": t}, remat=False, collect_cache=True,
        last_only=True, true_len=tl)[:2])
    jl, jc = fwd(params, jnp.asarray(padded), jnp.asarray(n, jnp.int32))
    pl, pc = PM.forward(cfg_p, PM.serving_params(tp),
                        torch.from_numpy(padded).long(), last_only=True,
                        true_len=None if n == 16 else n)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)
    assert np.array_equal(pl.argmax(-1).numpy(), np.asarray(jl).argmax(-1))
    for layer in range(cfg_p.num_layers):
        for f in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(
                pc[layer][f][0, :n].numpy(),
                np.asarray(jc["blocks"][0][f][layer])[0, :n])

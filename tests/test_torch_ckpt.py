"""Checkpoints, the training supervisor and the train CLI of the port, on
the CPU (counterparts of the non-mesh tests of
``tests/test_ckpt_runtime.py``), held against the JAX package where it has
a counterpart:

- save/restore identity, bit-exact compressed leaves, the compression of
  trained-like weights, ``LATEST`` and the gc, the async checkpointer,
  restore onto a named device;
- each leaf's ``codec`` and ``stored_bits`` equal to the JAX package's
  ``_save_leaf`` on the same f32, bf16 and small arrays (the same byte
  planes, tables and coder: bit-identical containers);
- the async save writes the state from before a step that follows it at
  once, even one that updates the tensors in place;
- a JAX-converted param tree (with int8 AdamW moments) saved compressed,
  restored, and ``params_to_numpy`` of it bit-equal to the JAX tree;
- the supervisor: completion, restart from the latest checkpoint after
  injected failures (bit-exact), giving up, the straggler watchdog;
- ``launch/train.py --smoke --device cpu`` training, compressing its
  checkpoint and resuming from it.
"""
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.ckpt import checkpoint as jckpt
from repro.models import model as JM
from repro_torch import configs as pconfigs
from repro_torch import tree as T
from repro_torch.ckpt import checkpoint as ckpt
from repro_torch.launch import train as cli
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.runtime import Supervisor, SupervisorConfig
from repro_torch.train import AdamWConfig, Q8, init_state


def _tree():
    """The reference test's tree, as tensors."""
    rng = np.random.default_rng(0)
    return {
        "w": torch.from_numpy(rng.normal(0, 0.02, (256, 128))
                              .astype(np.float32)),
        "b16": torch.from_numpy(rng.normal(0, 1, (128, 64))
                                .astype(np.float32)).to(torch.bfloat16),
        "step": torch.tensor(7, dtype=torch.int32),
        "nested": {"scale": torch.ones(64)},
        "moments": [Q8(torch.ones(4, 32, dtype=torch.int8),
                       torch.full((4, 1), 0.5))],
    }


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(a, b) -> None:
    fa, sa = T.flatten(a)
    fb, sb = T.flatten(b)
    assert sa == sb and len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert _bits(x) == _bits(y)


@pytest.mark.parametrize("compress", [False, True])
def test_save_restore_identity(tmp_path, compress):
    """Every leaf back bit for bit with its dtype, ``Q8`` moments kept as
    ``Q8``, the extra state and the step; compressed, the f32 matrix as
    an ``apack_byteplane`` container (the bf16 one stays raw, as the
    reference's rule keeps it)."""
    t = _tree()
    d = ckpt.save(tmp_path, 5, t, extra={"foo": 1}, compress=compress,
                  device="cpu")
    out, extra, step = ckpt.restore(tmp_path, device="cpu")
    assert step == 5 and extra == {"foo": 1}
    _same(t, out)
    assert isinstance(out["moments"][0], Q8)
    with open(d / "manifest.json") as f:
        codecs = [leaf["codec"] for leaf in json.load(f)["leaves"]]
    assert codecs.count("apack_byteplane") == (1 if compress else 0)


def test_leaf_codec_equals_jax(tmp_path):
    """``codec`` and ``stored_bits`` of every leaf equal the JAX
    package's ``_save_leaf`` on the same values: f32 trained-like and
    normal, bf16, one under 4096 elements, an int one."""
    rng = np.random.default_rng(3)
    arrs = {"w": rng.normal(0, 0.02, (512, 64)).astype(np.float32),
            "n": rng.normal(0, 1, (64, 80)).astype(np.float32),
            "b16": rng.normal(0, 1, (64, 96)).astype(np.float32),
            "small": rng.normal(0, 1, (1000,)).astype(np.float32),
            "ids": rng.integers(0, 9, (5000,)).astype(np.int32)}
    for name, a in arrs.items():
        ja = a.astype(jnp.bfloat16) if name == "b16" else a
        want = jckpt._save_leaf(tmp_path / f"j_{name}", np.asarray(ja), True)
        t = torch.from_numpy(a)
        if name == "b16":
            t = t.to(torch.bfloat16)
        got = ckpt._save_leaf(tmp_path / f"p_{name}", t, True, "cpu")
        assert got == want, name


def test_compression_shrinks_trained_like_weights(tmp_path):
    rng = np.random.default_rng(0)
    t = {"w": torch.from_numpy(rng.normal(0, 0.02, (512, 512))
                               .astype(np.float32))}
    d = ckpt.save(tmp_path, 1, t, compress=True, device="cpu")
    with open(d / "manifest.json") as f:
        man = json.load(f)
    assert sum(leaf["stored_bits"] for leaf in man["leaves"]) \
        < 512 * 512 * 32 * 0.92


def test_latest_pointer_and_gc(tmp_path):
    t = {"x": torch.arange(4.0)}
    for s in (1, 2, 3, 4, 5):
        ckpt.save(tmp_path, s, t, keep=2)
    assert ckpt.latest_step(tmp_path) == 5
    dirs = sorted(p.name for p in tmp_path.iterdir()
                  if p.name.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(tmp_path / "none", device="cpu")


def test_async_save_writes_the_state_before_the_step(tmp_path):
    """``AsyncCheckpointer.save`` returns after its host snapshot; the
    step that follows at once (here one that writes the tensors in place,
    and a new tree as ``apply_updates`` makes) cannot reach what is
    written.  Its part seconds are recorded."""
    timings: dict = {}
    saver = ckpt.AsyncCheckpointer(tmp_path, compress=True, device="cpu",
                                   timings=timings)
    t = _tree()
    want = T.map(torch.clone, t)
    saver.save(3, t)
    t["w"].add_(1.0)                           # an in-place step
    t["nested"]["scale"].mul_(3.0)
    saver.wait()
    out, _, step = ckpt.restore(tmp_path, device="cpu")
    assert step == 3
    _same(want, out)
    assert {"snapshot", "encode", "write", "total"} <= set(timings)


def test_jax_tree_round_trip(tmp_path):
    """xlstm SMOKE params from the JAX init, converted, with int8 AdamW
    moments: saved compressed and restored, the params in the JAX layout
    bit-equal to the JAX tree, the moments as saved."""
    cj = jconfigs.get_smoke_config("xlstm-125m")
    cp = pconfigs.get_smoke_config("xlstm-125m")
    jp = jax.tree.map(np.array, jax.jit(JM.init_params, static_argnums=0)(
        cj, jax.random.PRNGKey(0)))
    params = params_from_numpy(cp, jp, "cpu")
    state = {"params": params,
             "opt": init_state(AdamWConfig(state_dtype="int8"), params)}
    ckpt.save(tmp_path, 1, state, compress=True, device="cpu")
    out, _, _ = ckpt.restore(tmp_path, device="cpu")
    _same(state, out)
    back = params_to_numpy(cp, out["params"])
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# -------------------------------------------------------------- supervisor
def _sup(tmp_path, fail_at=(), max_steps=20, **kw):
    calls = {"n": 0}

    def make_state():
        return {"x": torch.zeros(())}, {}

    def step_fn(state, step_idx):
        calls["n"] += 1
        if calls["n"] in fail_at:
            raise RuntimeError(f"injected failure at call {calls['n']}")
        return {"x": state["x"] + 1}, {"loss": float(state["x"])}

    cfg = SupervisorConfig(ckpt_dir=str(tmp_path), save_every=5,
                           max_steps=max_steps, async_save=False, **kw)
    return Supervisor(cfg, make_state=make_state, step_fn=step_fn,
                      device="cpu")


def test_supervisor_runs_and_restarts(tmp_path):
    state, hist = _sup(tmp_path / "a").run()
    assert float(state["x"]) == 20 and len(hist) == 20
    sup = _sup(tmp_path / "b", fail_at=(8, 13))
    state, hist = sup.run()
    assert sup.restarts == 2
    # bit-exact final state despite two failures (restored from step 5/10)
    assert float(state["x"]) == 20
    with pytest.raises(RuntimeError):
        _sup(tmp_path / "c", fail_at=tuple(range(1, 100)),
             max_restarts=3).run()


def test_straggler_watchdog_flags(tmp_path):
    calls = {"n": 0}

    def make_state():
        return {"x": torch.zeros(())}, {}

    def step_fn(state, step_idx):
        calls["n"] += 1
        if calls["n"] >= 12:
            time.sleep(0.3)       # sustained straggle
        return state, {}

    cfg = SupervisorConfig(ckpt_dir=str(tmp_path), save_every=100,
                           max_steps=30, async_save=False,
                           straggler_ratio=4.0, straggler_patience=2,
                           max_restarts=0)
    sup = Supervisor(cfg, make_state=make_state, step_fn=step_fn,
                     device="cpu")
    with pytest.raises(TimeoutError):
        sup.run()
    assert sup.straggler_events >= 2


def test_train_cli_compresses_and_resumes(tmp_path, capsys):
    """Four steps of xlstm SMOKE with int8 moments and a compressed
    checkpoint at step 4; a second run to step 6 resumes from it (its data
    cursor too) and logs only steps 5 and 6."""
    args = ["--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq",
            "16", "--save-every", "4", "--ckpt-dir", str(tmp_path),
            "--state-dtype", "int8", "--device", "cpu", "--log-every", "1"]
    hist = cli.main(args + ["--steps", "4", "--compress-ckpt"])
    assert [h["step"] for h in hist] == [1, 2, 3, 4]
    assert all(np.isfinite(h["loss"]) for h in hist)
    man = json.loads((tmp_path / "step_00000004" / "manifest.json")
                     .read_text())
    assert "apack_byteplane" in {leaf["codec"] for leaf in man["leaves"]}
    assert json.loads((tmp_path / "step_00000004" / "extra.json")
                      .read_text())["data"] == {"step": 4}
    hist2 = cli.main(args + ["--steps", "6"])
    assert [h["step"] for h in hist2] == [5, 6]
    assert "final loss" in capsys.readouterr().out

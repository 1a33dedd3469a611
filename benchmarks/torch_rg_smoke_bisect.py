#!/usr/bin/env python3
"""Locate the op at which recurrentgemma-9b SMOKE's prefill parts between
the card and the CPU (the port only; no JAX).

    python3 benchmarks/torch_rg_smoke_bisect.py

Builds the SMOKE config with window 8 and seed-0 weights on the CPU, as
``chip_smoke.py``'s ``smoke_vs_cpu`` does, and runs the first request's
bucketed prefill (``ServeEngine._prefill_forward``, 20 tokens in a bucket
of 32) on the CPU and on the card with every function of
``repro_torch.models.modules`` and ``repro_torch.models.model`` wrapped to
record its tensor inputs and outputs.  Records are compared in the order
the calls return, so the first record whose outputs differ while its
inputs are equal names the function that parts; its shapes and dtypes
are printed.  That function is then run again on its recorded inputs, on
each device, under a ``TorchFunctionMode`` that records every torch call
inside it, which names the first torch op whose inputs agree and whose
outputs do not.  For each elementwise op among those that part, the
card's result is held against the CPU's over 2^24 f32 inputs spread over
the range the op saw (and the op's own inputs), natively and computed in
f64 and rounded to f32, with the count of values that differ.  The
prefill logits' largest difference is printed for each setting of
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
(cuBLAS may reduce split-K partial sums in bf16 when it is on).  Needs
one card; exits non-zero without one.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def tensors(x):
    """The tensors in a nest of tuples, lists and dicts, in order."""
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in tensors(v)]
    if isinstance(x, dict):
        return [t for k in x for t in tensors(x[k])]
    return []


def recorded(mods, log):
    """Wrap every function defined in ``mods`` to append (name, inputs,
    outputs, the function, its args and kwargs) to ``log`` when it
    returns; returns the undo list."""
    undo = []
    for mod in mods:
        for name, fn in list(vars(mod).items()):
            if not inspect.isfunction(fn) or fn.__module__ != mod.__name__:
                continue

            def wrap(*a, _fn=fn, _name=f"{mod.__name__}.{name}", **k):
                out = _fn(*a, **k)
                log.append((_name,
                            [t.detach().cpu() for t in tensors((a, k))],
                            [t.detach().cpu() for t in tensors(out)],
                            _fn, a, k))
                return out
            setattr(mod, name, wrap)
            undo.append((mod, name, fn))
    return undo


class OpLog:
    """A ``TorchFunctionMode`` recording (name, tensor inputs, tensor
    outputs) of every torch call made under it, on the CPU."""

    def __new__(cls, log):
        from torch.overrides import TorchFunctionMode

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                name = getattr(func, "__name__", str(func))
                log.append((name, [t.detach().cpu() for t in
                                   tensors((args, kwargs or {}))],
                            [t.detach().cpu() for t in tensors(out)]))
                return out
        return Mode()


def op_by_op(fn, a, k, dev):
    """Run ``fn`` on copies of its recorded inputs on ``dev`` and record
    every torch call."""
    import torch

    def on(x):
        if isinstance(x, torch.Tensor):
            return x.to(dev)
        if isinstance(x, dict):
            return {kk: on(v) for kk, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(on(v) for v in x)
        return x
    log = []
    with OpLog(log):
        fn(*on(a), **on(k))
    return log


def sweep(name, xs, dev):
    """An elementwise op on the CPU against the card, natively and in f64
    rounded to f32, over ``xs`` (f32): counts of differing values."""
    import torch
    fn = {"exp": torch.exp, "sigmoid": torch.sigmoid, "log1p": torch.log1p,
          "tanh": torch.tanh, "sqrt": torch.sqrt,
          "logaddexp": lambda x: torch.logaddexp(x, torch.zeros_like(x))
          }.get(name)
    if fn is None:
        return None
    want = fn(xs)
    card = fn(xs.to(dev)).cpu()
    card64 = fn(xs.to(dev).double()).float().cpu()
    cpu64 = fn(xs.double()).float()
    return {"values": xs.numel(),
            "card_vs_cpu": int((card != want).sum()),
            "card_f64_vs_cpu": int((card64 != want).sum()),
            "cpu_f64_vs_cpu": int((cpu64 != want).sum()),
            "max_abs_diff": float((card - want).abs().max())}


def equal(a, b) -> bool:
    import torch
    return len(a) == len(b) and all(
        x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
        for x, y in zip(a, b))


def prefill(dev, params, cfg, prompt, log=None):
    import torch
    from repro_torch.models import model as M
    from repro_torch.models import modules as m
    from repro_torch.serve import ServeEngine
    p = {"embed": params["embed"].to(dev),
         "final_norm": params["final_norm"].to(dev),
         "blocks": [{k: ({kk: vv.to(dev) for kk, vv in v.items()}
                         if isinstance(v, dict) else v.to(dev))
                     for k, v in b.items()} for b in params["blocks"]]}
    eng = ServeEngine(cfg, p, max_batch=2, max_len=64, kv_page_size=4,
                      kv_calib_pages=2, device=dev)
    undo = recorded((m, M), log) if log is not None else []
    try:
        logits, _ = eng._prefill_forward(prompt)
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return logits.float().cpu()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_rg_smoke_bisect: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(HERE, "..", "src"))
    import numpy as np
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_smoke_config("recurrentgemma-9b"),
                              kv_cache_dtype="apack-int8", window_size=8)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = np.random.default_rng(1).integers(0, 512, 20)
    cpu, card = [], []
    cuda = torch.device("cuda", 0)
    base = prefill(torch.device("cpu"), params, cfg, prompt, cpu)
    got = prefill(cuda, params, cfg, prompt, card)
    print(f"records: cpu {len(cpu)}, card {len(card)}; prefill logits max "
          f"diff {(got - base).abs().max().item():.6g}")
    first = None
    differing = []
    for i, ((n, ai, ao, *_), (n2, bi, bo, *_)) in enumerate(zip(cpu,
                                                                   card)):
        if n != n2:
            print(f"call order parts at record {i}: {n} vs {n2}")
            break
        if not equal(ao, bo):
            differing.append(n.rsplit(".", 1)[1])
            if first is None and equal(ai, bi):
                first = (i, n, ai, ao, bo, cpu[i][3], cpu[i][4], cpu[i][5])
    print(f"records with differing outputs: {len(differing)}; the first "
          f"30: {differing[:30]}")
    if first is None:
        print("no op parts with equal inputs (a difference enters between "
              "recorded calls)")
    else:
        i, n, ai, ao, bo, fn, fa, fk = first
        d = max((x.float() - y.float()).abs().max().item()
                for x, y in zip(ao, bo))
        print("first op to part with equal inputs: " + json.dumps({
            "record": i, "op": n,
            "inputs": [[list(t.shape), str(t.dtype)] for t in ai],
            "outputs": [[list(t.shape), str(t.dtype)] for t in ao],
            "max_abs_diff": d,
            "elements_differing": int(sum(
                (x != y).sum().item() for x, y in zip(ao, bo)))}))
        ops_c = op_by_op(fn, fa, fk, torch.device("cpu"))
        ops_d = op_by_op(fn, fa, fk, cuda)
        parted = []
        for (on_, oi, oo), (_, di, do) in zip(ops_c, ops_d):
            if equal(oi, di) and not equal(oo, do):
                xs = [t for t in oi if t.is_floating_point()]
                parted.append((on_, oi, oo, do))
                print("  op that parts with equal inputs: " + json.dumps({
                    "op": on_, "inputs": [[list(t.shape), str(t.dtype)]
                                          for t in oi],
                    "elements_differing": int(sum(
                        (x != y).sum().item() for x, y in zip(oo, do))),
                    "max_abs_diff": max((x.float() - y.float()).abs().max()
                                        .item() for x, y in zip(oo, do)),
                    "input_range": [min(float(t.min()) for t in xs),
                                    max(float(t.max()) for t in xs)]
                    if xs else None}))
        for on_ in sorted({p[0] for p in parted}):
            oi = next(p[1] for p in parted if p[0] == on_)
            lo = min(float(t.min()) for t in oi if t.is_floating_point())
            hi = max(float(t.max()) for t in oi if t.is_floating_point())
            g = torch.Generator().manual_seed(0)
            xs = torch.cat([lo + (hi - lo) * torch.rand(1 << 24, generator=g)]
                           + [t.float().reshape(-1) for t in oi
                              if t.is_floating_point()])
            print(f"  sweep {on_} over [{lo:.4g}, {hi:.4g}]: "
                  + json.dumps(sweep(on_, xs, cuda)))
    flags = torch.backends.cuda.matmul
    for setting in (True, False):
        flags.allow_bf16_reduced_precision_reduction = setting
        got = prefill(cuda, params, cfg, prompt)
        print(f"allow_bf16_reduced_precision_reduction={setting}: prefill "
              f"logits max diff {(got - base).abs().max().item():.6g}")
    flags.allow_bf16_reduced_precision_reduction = True
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Synthetic value distributions matching the paper's workload statistics.

Port of ``repro/core/distributions.py`` (a numpy copy: the port
imports nothing of the JAX package).

The paper profiles real int8-quantized models (Table II).  We cannot ship
those weights; instead these generators reproduce the *distribution shapes*
the paper identifies (Fig. 2 + §VII-A discussion), and the benchmark suite
additionally profiles the real weights/activations of this repo's own model
zoo (the 10 assigned architectures).
"""
from __future__ import annotations

import numpy as np


def gaussian_weights(n: int, sigma: float = 12.0, seed: int = 0) -> np.ndarray:
    """Symmetric-quantized conv/linear weights: int8 two's complement view —
    bimodal near 0 and 255 (paper Fig. 2)."""
    rng = np.random.default_rng(seed)
    w = np.clip(np.round(rng.normal(0.0, sigma, n)), -128, 127).astype(np.int64)
    return (w & 0xFF).astype(np.uint8)


def noisy_weights(n: int, seed: int = 0) -> np.ndarray:
    """TorchVision-style 'noisy' quantization: full range used, heavy
    near-zero mass plus uniform noise floor (paper §VII-A)."""
    rng = np.random.default_rng(seed)
    core = np.clip(np.round(rng.normal(0.0, 25.0, int(n * 0.85))), -128, 127)
    noise = rng.integers(-128, 128, n - core.size)
    w = np.concatenate([core, noise]).astype(np.int64)
    rng.shuffle(w)
    return (w & 0xFF).astype(np.uint8)


def relu_activations(n: int, sparsity: float = 0.5, scale: float = 20.0,
                     seed: int = 0) -> np.ndarray:
    """Post-ReLU uint8 activations: ``sparsity`` exact zeros + exponential
    tail (the paper's 'high sparsity ... ReLU' case)."""
    rng = np.random.default_rng(seed)
    a = rng.exponential(scale, n)
    a = np.where(rng.random(n) < sparsity, 0.0, a)
    return np.clip(np.round(a), 0, 255).astype(np.uint8)


def pruned_weights(n: int, sparsity: float = 0.85, sigma: float = 18.0,
                   seed: int = 0) -> np.ndarray:
    """Eyeriss-style pruned model weights: mostly zeros + gaussian survivors."""
    rng = np.random.default_rng(seed)
    w = np.clip(np.round(rng.normal(0.0, sigma, n)), -128, 127).astype(np.int64)
    w = np.where(rng.random(n) < sparsity, 0, w)
    return (w & 0xFF).astype(np.uint8)


def pact4_weights(n: int, seed: int = 0) -> np.ndarray:
    """4-bit PACT-quantized weights in an 8-bit container's low nibble space
    (paper's ResNet18-PACT case: int4 layers)."""
    rng = np.random.default_rng(seed)
    w = np.clip(np.round(rng.normal(0.0, 2.2, n)), -8, 7).astype(np.int64)
    return (w & 0xF).astype(np.uint8)


PAPER_LIKE = {
    "gaussian_weights": gaussian_weights,
    "noisy_weights": noisy_weights,
    "relu_activations": relu_activations,
    "pruned_weights": pruned_weights,
    "pact4_weights": pact4_weights,
}

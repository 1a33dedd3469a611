"""Fused APack-decompress + matmul: the CUDA kernel's wrapper, its plain
version, and the weight packing around them.

Port of ``repro/kernels/decompress_matmul.py``: ``TILE_N``,
``DEFAULT_TILE_K``, ``DEFAULT_WEIGHT_MIN_SIZE``, ``CompressedLinear`` :48,
``compress_quantized`` :81, ``compress_linear`` :120, ``_fused_kernel``
:170 / ``compressed_matmul`` :216 (``csrc/decompress_matmul.cu``) and
``reference_matmul`` :261.

A weight matrix W[K, N] lives on the device as word-interleaved APack
planes: it is tiled into (K_pad / tile_k) x (N_pad / 128) tiles, and stream
``c`` of tile ``(kt, j)`` holds column ``j*128 + c`` over rows
``kt*tile_k ..``, streams ordered kt-major.  ``compressed_matmul`` decodes
each tile once, dequantizes it with the per-column scale and sums the K
tiles' f32 partial products in kt order.

Row-parallel tensor parallelism (``packed_proj`` :113-135): the stream
axis is kt-major, so a contiguous range of streams is a contiguous range
of K tiles.  ``split_k`` cuts a weight into such ranges, one a model shard,
each a ``CompressedLinear`` of ``k / n`` rows that the kernel runs as it
runs any weight: its wrapper reads only the weight's own layout, so the
kernel body is unchanged.  The shards' partial products are summed by the
caller (``models.sharding.psum``).

``stack_compressed`` (:138) is not ported: it stacks per-layer planes for
``lax.scan``, and the port keeps one param dict per layer
(``models/convert.py``), so each layer holds its own ``CompressedLinear``.
"""
from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from repro_torch.core import quant
from repro_torch.core.tables import ApackTable, find_table

from . import _build, apack_decode, apack_encode, ref

F32 = torch.float32
I32 = torch.int32
TILE_N = 128      # streams per tile == threads per block
DEFAULT_TILE_K = 512
# Smallest element count for which the serving layer compresses a weight
# tensor: ``model.pack_weights`` and the ``--weight-min-size`` CLI flag share
# this one default.
DEFAULT_WEIGHT_MIN_SIZE = 16384
# dynamic shared memory a block may use on sm_90 (a block stages the planes
# of 64 streams, and for more than 8 rows of x an int8 tile_k x 64 tile)
_MAX_SMEM = 232448

_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 13 + [ctypes.c_void_p]


@dataclasses.dataclass
class CompressedLinear:
    """An APack-compressed [K, N] weight matrix and its dequant metadata.
    Planes hold u32 words in int32 tensors (the kernels read ``uint32_t``)."""

    sym_plane: torch.Tensor   # int32 [Ws, S_total]
    ofs_plane: torch.Tensor   # int32 [Wo, S_total]
    stored: torch.Tensor      # int32 [S_total]
    v_min: torch.Tensor       # int32 [17]
    ol: torch.Tensor          # int32 [16]
    cum: torch.Tensor         # int32 [17]
    scale: torch.Tensor       # f32 [N_pad] per-output-column dequant scale
    k: int                    # original K
    n: int                    # original N
    tile_k: int
    payload_bits: int         # coded payload (for traffic accounting)

    @property
    def k_pad(self) -> int:
        return -(-self.k // self.tile_k) * self.tile_k

    @property
    def n_pad(self) -> int:
        return -(-self.n // TILE_N) * TILE_N


def compress_quantized(q, scale, tile_k: int = DEFAULT_TILE_K,
                       table: ApackTable | None = None) -> CompressedLinear:
    """APack-compress an already-quantized int8 weight matrix.

    ``q``: int8-valued [K, N]; ``scale``: f32 [N] per-output-column dequant
    scale (tensors or numpy arrays; the planes land on ``q``'s device).  The
    weight-mode table comes from the histogram of the zero-padded
    [K_pad, N_pad] two's-complement view, padding included, as in the JAX
    package; the streams are coded by ``apack_encode.encode`` (the CUDA
    kernel on the card, ``ref.encode`` on the CPU)."""
    q = torch.as_tensor(q)
    dev = q.device
    k, n = q.shape
    scale = torch.as_tensor(scale, dtype=F32, device=dev).reshape(-1)
    if scale.shape != (n,):
        raise ValueError(f"scale shape {tuple(scale.shape)}, expected ({n},)")
    streams = tile_streams(q, tile_k)
    if table is None:
        # the streams hold exactly the padded array's values
        hist = torch.bincount(streams.reshape(-1), minlength=256)
        table = find_table(hist.cpu().numpy().astype(np.int64), bits=8,
                           is_activation=False)
    n_pad = -(-n // TILE_N) * TILE_N
    v_min, ol, cum = ref.table_tensors(table, dev)
    sp, op, sb, ob, stored = apack_encode.encode(streams, v_min, ol, cum,
                                                 n_steps=tile_k, bits=8)
    payload = int(sb.sum() + ob.sum())
    scale_pad = torch.zeros(n_pad, dtype=F32, device=dev)
    scale_pad[:n] = scale
    return CompressedLinear(sym_plane=sp, ofs_plane=op, stored=stored.to(I32),
                            v_min=v_min, ol=ol, cum=cum, scale=scale_pad,
                            k=k, n=n, tile_k=tile_k, payload_bits=payload)


def tile_streams(q: torch.Tensor, tile_k: int) -> torch.Tensor:
    """The APack streams of an int8 [K, N] matrix: its two's-complement
    values zero-padded to [K_pad, N_pad], stream ``(kt*nn + j)*128 + c``
    holding column ``j*128 + c`` over the rows of K tile ``kt``.  Returns
    int32 [nk * nn * 128, tile_k]."""
    k, n = q.shape
    k_pad = -(-k // tile_k) * tile_k
    n_pad = -(-n // TILE_N) * TILE_N
    up = torch.zeros(k_pad, n_pad, dtype=I32, device=q.device)  # pad == q 0
    up[:k, :n] = quant.to_unsigned(q)
    nk, nn = k_pad // tile_k, n_pad // TILE_N
    return (up.reshape(nk, tile_k, nn, TILE_N)
              .permute(0, 2, 3, 1)                        # [nk, nn, NS, E]
              .reshape(nk * nn * TILE_N, tile_k).contiguous())


def compress_linear(w, tile_k: int = DEFAULT_TILE_K,
                    table: ApackTable | None = None) -> CompressedLinear:
    """Quantize (symmetric int8 per output column, over every leading axis)
    and APack-compress a weight matrix."""
    w = torch.as_tensor(w).to(F32)
    q, qp = quant.quantize_symmetric(w, axis=-1)
    return compress_quantized(q, qp.scale.reshape(-1), tile_k, table)


def dequantized_weight(cw: CompressedLinear) -> torch.Tensor:
    """f32 [K_pad, N_pad]: every tile decoded with the plain decoder,
    reinterpreted as two's complement and times its column's scale (the
    reference's ``w_tile = signed.T * scale``)."""
    e = cw.tile_k
    vals = ref.decode(cw.sym_plane, cw.ofs_plane, cw.stored, cw.v_min,
                      cw.ol, cw.cum, e, 8)                 # [S, E]
    nk, nn = cw.k_pad // e, cw.n_pad // TILE_N
    w = (vals.reshape(nk, nn, TILE_N, e).permute(0, 3, 1, 2)
             .reshape(cw.k_pad, cw.n_pad))
    signed = torch.where(w >= 128, w - 256, w).to(F32)
    return signed * cw.scale[None, :]


def compressed_matmul_plain(x: torch.Tensor,
                            cw: CompressedLinear) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same arguments and result as
    :func:`compressed_matmul`: one f32 product per K tile, summed in kt
    order as the kernel and the JAX kernel sum them.  Rows of x are
    zero-padded to a multiple of 8, as the JAX kernel pads them to its row
    blocks (``block_m >= 8``): a CPU product of one or two rows would take
    a matrix-vector path that sums in another order."""
    m, k = x.shape
    wf = dequantized_weight(cw)
    e = cw.tile_k
    xp = torch.zeros(-(-m // 8) * 8, cw.k_pad, dtype=F32, device=x.device)
    xp[:m, :k] = x.to(F32)
    acc = xp[:, :e] @ wf[:e]
    for kt in range(1, cw.k_pad // e):
        acc = acc + xp[:, kt * e:(kt + 1) * e] @ wf[kt * e:(kt + 1) * e]
    return acc[:m, :cw.n]


def _tiled_x(x: torch.Tensor, tile_k: int, nk: int):
    """x as the kernel reads it: ``(xt, ldx, xkt)`` with element (r, K tile
    kt, column i) at ``xt[r * ldx + kt * xkt + i]``, every 8th column
    16-byte aligned, readable to the next multiple of 8 past tile_k and zero
    past K.  An f32 x whose K tiles are whole and 8-column aligned is used
    as it is; any other is copied into a zeroed [M, nk, tile_k rounded up
    to 8] buffer."""
    m, k = x.shape
    xf = x.to(F32).contiguous()
    if tile_k % 8 == 0 and k == nk * tile_k and xf.data_ptr() % 16 == 0:
        return xf, k, tile_k
    t8 = -(-tile_k // 8) * 8
    xt = torch.zeros(m, nk, t8, dtype=F32, device=x.device)
    xt[:, :, :tile_k] = torch.nn.functional.pad(
        xf, (0, nk * tile_k - k)).view(m, nk, tile_k)
    return xt, nk * t8, t8


def compressed_matmul(x: torch.Tensor, cw: CompressedLinear, *,
                      stage_only: bool = False) -> torch.Tensor:
    """``x @ W`` where W is APack-compressed; x f32 or bf16 [M, K], computed
    in f32, result f32 [M, N].

    The JAX version's ``block_m`` has no counterpart: the kernel walks every
    row of x against each decoded tile.  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel or raises.  ``stage_only``
    (CUDA only, for timing the kernel's parts) runs the kernel up to the
    copy of the planes into shared memory and returns an unwritten
    output; it is not counted as a launch."""
    _build.refuse_fake("compressed_matmul", x, cw.sym_plane, cw.scale)
    if x.dim() != 2 or x.shape[1] != cw.k:
        raise ValueError(f"x shape {tuple(x.shape)}, expected [M, {cw.k}]")
    if x.device.type == "cpu":
        return compressed_matmul_plain(x, cw)
    if x.device.type != "cuda":
        raise ValueError(f"compressed_matmul: unsupported device {x.device}")
    dev = x.device
    m = x.shape[0]
    nk, nn = cw.k_pad // cw.tile_k, cw.n_pad // TILE_N
    xf, ldx, xkt = _tiled_x(x, cw.tile_k, nk)
    s = nk * nn * TILE_N
    ws, wo = cw.sym_plane.shape[0], cw.ofs_plane.shape[0]
    rs, ro = apack_decode.staged_rows(cw.tile_k, 8, ws, wo)
    lib = _build.load("decompress_matmul")
    fn = lib.decompress_matmul_smem_bytes
    fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_int
    smem = fn(m, cw.tile_k, rs, ro)
    if smem > _MAX_SMEM:
        raise ValueError(f"tile_k={cw.tile_k}, M={m}: {smem} bytes of shared "
                         f"memory a block, above the {_MAX_SMEM} it has")
    partial = torch.empty(nk, m, cw.n_pad, dtype=F32, device=dev)
    out = torch.empty(m, cw.n, dtype=F32, device=dev)
    ptrs = [xf.data_ptr(),
            _build.require(cw.sym_plane, I32, (ws, s), "sym_plane", dev),
            _build.require(cw.ofs_plane, I32, (wo, s), "ofs_plane", dev),
            _build.require(cw.stored, I32, (s,), "stored", dev),
            _build.require(cw.v_min, I32, (17,), "v_min", dev),
            _build.require(cw.ol, I32, (16,), "ol", dev),
            _build.require(cw.cum, I32, (17,), "cum", dev),
            _build.require(cw.scale, F32, (cw.n_pad,), "scale", dev),
            partial.data_ptr(), out.data_ptr()]
    fn = lib.decompress_matmul_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    rc = _build.launch(fn, *ptrs, m, cw.k, cw.n, cw.tile_k, nk, nn, ws, wo,
                       rs, ro, ldx, xkt, int(stage_only), on=x)
    _build.check(rc, "decompress_matmul")
    if not stage_only:
        _build.LAUNCHES["decompress_matmul"] += 1
    return out


@dataclasses.dataclass(frozen=True)
class Layout:
    """A ``CompressedLinear``'s shape and coded size without its tensors:
    what a weight split into K ranges keeps of the whole
    (``models.modules.ShardedPackedWeight``), so that the whole planes
    need not stay beside the parts."""

    k: int
    n: int
    tile_k: int
    payload_bits: int

    @classmethod
    def of(cls, cw: CompressedLinear) -> "Layout":
        return cls(cw.k, cw.n, cw.tile_k, cw.payload_bits)

    @property
    def k_pad(self) -> int:
        return -(-self.k // self.tile_k) * self.tile_k

    @property
    def n_pad(self) -> int:
        return -(-self.n // TILE_N) * TILE_N


def k_splittable(cw: CompressedLinear, n_parts: int) -> bool:
    """Whether ``cw`` splits into ``n_parts`` K ranges of whole tiles
    (``packed_param_specs`` :656): K unpadded and the K tiles dividing
    evenly."""
    nk = cw.k_pad // cw.tile_k
    return n_parts > 1 and cw.k == cw.k_pad and nk % n_parts == 0


def split_k(cw: CompressedLinear, n_parts: int) -> list[CompressedLinear]:
    """``cw`` cut into ``n_parts`` contiguous K-tile ranges, in order: part
    ``j`` holds the streams of K tiles ``[j nk/n, (j+1) nk/n)`` (copied to
    their own contiguous planes) and computes ``x[:, j k/n:(j+1) k/n] @
    W[j k/n:(j+1) k/n]``.  Tables and column scales are shared; the coded
    size stays accounted on the whole weight (``payload_bits`` 0)."""
    if not k_splittable(cw, n_parts):
        raise ValueError(f"K {cw.k} in tiles of {cw.tile_k} does not split "
                         f"into {n_parts} whole-tile ranges")
    per = (cw.k_pad // cw.tile_k // n_parts) * (cw.n_pad // TILE_N) * TILE_N
    return [dataclasses.replace(
        cw, sym_plane=cw.sym_plane[:, j * per:(j + 1) * per].contiguous(),
        ofs_plane=cw.ofs_plane[:, j * per:(j + 1) * per].contiguous(),
        stored=cw.stored[j * per:(j + 1) * per].contiguous(),
        k=cw.k // n_parts, payload_bits=0) for j in range(n_parts)]


def reference_matmul(x: torch.Tensor, cw: CompressedLinear) -> torch.Tensor:
    """Oracle: decode with the plain decoder, dequantize, one dense f32
    product over the whole of K."""
    wf = dequantized_weight(cw)
    return (x.to(F32) @ wf[:cw.k])[:, :cw.n]

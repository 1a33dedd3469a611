"""APack quickstart on the PyTorch/CUDA port: tables, compression,
kernels, baselines.

Port of ``examples/quickstart.py``.

    PYTHONPATH=src python examples/quickstart_torch.py              # card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np

from repro_torch.core import baselines, distributions
from repro_torch.core.format import compress, decompress
from repro_torch.core.tables import table_for
from repro_torch.device import resolve
from repro_torch.kernels import ops


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda); 'cpu' runs the "
                         "kernels' plain versions")
    device = resolve(ap.parse_args(argv).device)

    # 1. a paper-like int8 weight tensor (bimodal two's-complement view)
    w = distributions.gaussian_weights(1 << 16, sigma=8.0)
    print(f"tensor: {w.size} uint8 values; "
          f"{np.mean(w <= 16) * 100:.0f}% near 0, "
          f"{np.mean(w >= 240) * 100:.0f}% near 255")

    # 2. profile -> probability-count table (paper Listing 1)
    table = table_for(w, is_activation=False)
    print("table v_min:", table.v_min)
    print("table counts:", tuple(b - a for a, b in zip(table.cum,
                                                       table.cum[1:])))

    # 3. golden-path container compression
    ct = compress(w[:8192], table)
    out = decompress(ct)
    assert np.array_equal(out, w[:8192])
    print(f"golden codec: {ct.ratio():.2f}x (lossless, "
          f"{ct.payload_bits} payload bits)")

    # 4. the codec on the device: the encode and decode kernels on the card,
    # their plain versions on the CPU (bit-identical)
    ca = ops.apack_encode(w, table, device=device)
    back = ops.apack_decode(ca)
    assert np.array_equal(back.cpu().numpy(), w)
    print(f"ops on {device}: roundtrip OK, "
          f"{w.size * 8 / ca.payload_bits:.2f}x payload ratio")

    # 5. versus the paper's baselines
    orig = w.size * 8
    print(f"RLE {orig / baselines.rle_bits(w):.2f}x | "
          f"RLEZ {orig / baselines.rlez_bits(w):.2f}x | "
          f"ShapeShifter {orig / baselines.shapeshifter_bits(w):.2f}x | "
          f"APack {orig / ca.payload_bits:.2f}x")


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Count where PyTorch's division of a CUDA tensor by a host scalar differs
from IEEE division, on the card.

    python scripts/scalar_division_check.py [--values 16777216]

``quantize_weight`` (``kernels/fused.py``) divides each channel's max by
127 as the JAX package does; PyTorch divides a CUDA tensor by a host
scalar as a product with the scalar's reciprocal (one rounding more), so
the port divides by a device tensor.  This script draws positive f32
values from seed 0 over a wide range of exponents and prints one JSON
line: how many of ``a / 127.0`` (host scalar), ``a / tensor(127.0)``
(device tensor) and the CPU's ``a / 127.0`` differ pairwise.  Needs one
CUDA card.
"""
import argparse
import json
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--values", type=int, default=1 << 24)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("scalar_division_check: no CUDA card is available",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    a = (torch.randn(args.values, generator=g, device=dev).abs()
         * torch.exp2(torch.randint(-60, 60, (args.values,), generator=g,
                                    device=dev).float()))
    host = a / 127.0
    tensor = a / a.new_full((), 127.0)
    cpu = (a.cpu() / 127.0).to(dev)
    print(json.dumps({
        "card": torch.cuda.get_device_name(dev), "values": args.values,
        "host_scalar_vs_device_tensor": int((host != tensor).sum()),
        "device_tensor_vs_cpu": int((tensor != cpu).sum()),
        "host_scalar_vs_cpu": int((host != cpu).sum())}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

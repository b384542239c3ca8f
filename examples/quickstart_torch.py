"""Quickstart on the PyTorch/CUDA port: the paper's algorithm end to end
on one page, as ``examples/quickstart.py`` walks it through the JAX
package.

  PYTHONPATH=src python examples/quickstart_torch.py              # the card
  PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (combinations_lex, combinatorial_addition, comb,
                              radic_det, radic_det_distributed,
                              radic_det_oracle, unrank_py)
from repro_torch.core.radic import resolve_device
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="device to compute on (cuda, cuda:N or cpu)")
    device = resolve_device(ap.parse_args(argv).device)

    # 1. Rank-addressable enumeration (paper §4, Example 1) --------------
    print("C(8,5) =", comb(8, 5))
    print("B_49 via combinatorial addition:",
          combinatorial_addition(49, 8, 5))
    print("   (paper says [2,5,6,7,8]; dictionary order check:",
          combinations_lex(8, 5)[49], ")")

    # 2. Radic determinant of a non-square matrix (Definition 3) ---------
    rng = np.random.default_rng(0)
    A = rng.normal(size=(4, 9)).astype(np.float32)
    T = torch.from_numpy(A).to(device)
    print("\nA is 4x9 => sum over C(9,4) =", comb(9, 4), "signed minors")
    print("oracle (numpy enumeration):", radic_det_oracle(A))
    print("flat torch (rank-parallel):",
          float(radic_det(T, backend="torch")))
    print("fused CUDA kernel         :", float(ops.radic_det_cuda(T)))
    print("mesh-distributed grains   :",
          float(radic_det_distributed(T, grains_per_device=4,
                                      device=device)))

    # 3. The grain scheme scales to bigint rank spaces -------------------
    n, m = 64, 32
    print(f"\nC({n},{m}) = {comb(n, m)} (≈1.8e18): grain starts still "
          "exact:")
    print("  grain 10^17 starts at", unrank_py(10**17, n, m)[:8], "...")


if __name__ == "__main__":
    main()

"""BLAS wiki samples — counterpart of ``examples/blas_wiki.py``
(example/wiki/blas/: abs, axpy, dot, fill, iamax, mult, nrm1/2/inf,
reciprocal, scal, update, gemv, gemm), on the same numpy draws."""
import numpy as np
import torch

from tpukk_torch import blas
from tpukk_torch.common import default_device


def main(device=None):
    dev = default_device(device)
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a).to(dev)

    x = t(rng.standard_normal(1000).astype(np.float32))
    y = t(rng.standard_normal(1000).astype(np.float32))

    out = dict(
        abs=blas.blas1.abs(x)[0], axpy=blas.axpy(2.0, x, y)[0], dot=blas.dot(x, y),
        fill=blas.fill(x, 3.0)[0], iamax=blas.iamax(x), mult=blas.mult(1.0, y, 2.0, x, y)[0],
        nrm1=blas.nrm1(x), nrm2=blas.nrm2(x), nrminf=blas.nrminf(x),
        reciprocal=blas.reciprocal(x)[0], scal=blas.scal(0.5, x)[0],
        update=blas.update(1.0, x, 2.0, y, 0.0, y)[0])
    for name in ("abs", "axpy", "dot", "fill", "iamax", "mult"):
        print(f"{name:5s}->", int(out[name]) if name == "iamax" else float(out[name]))
    print("nrm1 =", float(out["nrm1"]), " nrm2 =", float(out["nrm2"]),
          " nrminf =", float(out["nrminf"]))
    for name in ("reciprocal", "scal", "update"):
        print(f"{name} ->", float(out[name]))

    A = t(rng.standard_normal((64, 32)).astype(np.float32))
    v = t(rng.standard_normal(32).astype(np.float32))
    w = torch.zeros(64, dtype=torch.float32, device=dev)
    out["gemv"] = blas.gemv("N", 1.0, A, v, 0.0, w)[0]
    print("gemv ->", float(out["gemv"]))
    B = t(rng.standard_normal((32, 16)).astype(np.float32))
    C = torch.zeros((64, 16), dtype=torch.float32, device=dev)
    out["gemm"] = blas.gemm("N", "N", 1.0, A, B, 0.0, C)[0, 0]
    print("gemm ->", float(out["gemm"]))
    return out


if __name__ == "__main__":
    main()

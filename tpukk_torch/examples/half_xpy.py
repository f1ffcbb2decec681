"""Low-precision axpy — counterpart of ``examples/half_xpy.py``
(example/half/, fp16 xpy): bf16, ``tpukk``'s half type, is
``torch.bfloat16`` here, and a Python scalar keeps the result in bf16."""
import numpy as np
import torch

from tpukk_torch import blas
from tpukk_torch.common import default_device


def main(device=None):
    dev = default_device(device)
    x = torch.from_numpy(np.linspace(0, 1, 4096)).to(dev, torch.bfloat16)
    y = torch.from_numpy(np.linspace(1, 0, 4096)).to(dev, torch.bfloat16)
    z = blas.axpy(2.0, x, y)
    print("bf16 axpy: z[0] =", float(z[0]), " z[-1] =", float(z[-1]), " dtype =", z.dtype)
    assert z.dtype == torch.bfloat16
    return dict(x=x, y=y, z=z)


if __name__ == "__main__":
    main()

"""Batched general eigendecomposition — counterpart of
``examples/batched_eig.py`` (KokkosBatched Eigendecomposition: Hessenberg,
Schur, er/ei with conjugate pairs adjacent, left and right eigenvectors)."""
import numpy as np
import torch

from tpukk_torch.batched import eig, eigendecomposition, schur
from tpukk_torch.common import default_device


def main(device=None):
    dev = default_device(device)
    rng = np.random.default_rng(0)
    A = rng.standard_normal((4, 6, 6))
    At = torch.from_numpy(A).to(dev)

    w, VL, VR = eig(At)
    wh, VRh = w.cpu().numpy(), VR.cpu().numpy()
    res = max(np.linalg.norm(A[b] @ VRh[b][:, i] - wh[b, i] * VRh[b][:, i])
              for b in range(4) for i in range(6))
    print(f"batched eig: max right-eigenpair residual = {res:.2e}")

    T, Z = schur(At[0])
    Th, Zh = T.cpu().numpy(), Z.cpu().numpy()
    sim = np.abs(Zh @ Th @ Zh.conj().T - A[0]).max()
    print(f"schur: ||Z T Z^H - A|| = {sim:.2e}")

    er, ei, UL, UR = eigendecomposition(At[:1])
    print("er/ei (conjugate pairs adjacent):")
    for r, i in zip(er.cpu().numpy()[0], ei.cpu().numpy()[0]):
        print(f"  {r:+.4f} {i:+.4f}i")
    return dict(A=A, w=w, VL=VL, VR=VR, T=T, Z=Z, er=er, ei=ei, residual=res, similarity=sim)


if __name__ == "__main__":
    main()

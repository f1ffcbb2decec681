"""Graph wiki samples — counterpart of ``examples/graph_wiki.py`` (example/wiki/
graph/ and example/graph/: D1/D2 coloring, MIS2, RCB partitioning)."""
import numpy as np

from tpukk_torch.common import default_device
from tpukk_torch.containers import generate_structured_laplacian
from tpukk_torch.graph import graph_color, graph_color_d2, graph_mis2, rcb, verify_coloring


def main(device=None):
    A = generate_structured_laplacian(24, 24, device=default_device(device))
    colors = graph_color(A)
    valid = verify_coloring(A, colors)
    print(f"D1 coloring: {colors.max()} colors, valid = {valid}")
    assert valid

    d2 = graph_color_d2(A)
    print(f"D2 coloring: {d2.max()} colors")

    roots = graph_mis2(A)
    print(f"MIS-2: {len(roots)} roots out of {A.nrows} vertices")

    pts = np.stack(np.meshgrid(np.arange(24), np.arange(24)), -1).reshape(-1, 2).astype(float)
    parts = rcb(pts, 4)
    print("RCB part sizes:", np.bincount(parts, minlength=4).tolist())
    return dict(colors=colors, d2=d2, roots=roots, parts=parts)


if __name__ == "__main__":
    main()

"""Examples that run on the port's modules alone, one a module, each with a
``main(device=None)`` that runs on the CUDA device unless given
``device="cpu"``::

    python -m tpukk_torch.examples.graph_wiki
    python -c "from tpukk_torch.examples import graph_wiki; graph_wiki.main(device='cpu')"

Each mirrors the ``tpukk`` example of its name under ``examples/``.
"""

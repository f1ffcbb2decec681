"""Drivers: the system under test, as one file each (``<driver>.py``, named
by a mix), which the harness calls and nothing else.  A driver module has:

- ``load(arrays, device)``: the port's matrix from the configuration's CSR
  arrays (``row_map``, ``entries``, ``values``, ``nrows``, ``ncols``) on
  ``device``;
- ``prepare(A, cfg, mix)``: the port's set-up of the solver; a state with
  ``Ah(x)`` (the SpMV), ``prec.apply(r)`` (the preconditioner) and
  ``tables`` (name → function that copies what the set-up derived to the
  host, for the reference to judge);
- ``solve(state, b)``: (x, iterations, converged), from x0 = 0;
- ``make_spmv(A)``, ``make_prec(A, mix)``: the single operations on a copy
  of the matrix (the rooflines' ring of copies).

A cell of c > 1 chips runs its driver on every rank, one process a card
(``kkbench/ranks.py``), all in step, inside a ``torch.distributed`` process
group that the harness has joined (NCCL on the cards, gloo on the CPU; the
default group, the driver's for its collectives):

- ``load`` gets the rank's part, from ``build_part`` in ``matrices/``: its
  ``nrows`` rows, columns global (``ncols`` the whole matrix's), ``row0``
  its first global row; the whole matrix is the parts in rank order;
- ``prepare``, ``make_spmv`` and ``make_prec`` run on every rank together,
  and may gather what the port's set-up needs; no rank holds the whole
  matrix once ``prepare`` has returned;
- ``state.Ah``, ``state.prec.apply`` and ``solve`` take and return the
  rank's slice of each vector (its rows), and every rank returns the same
  iterations and convergence;
- a table holds the rank's rows of the whole's table: rank 0 concatenates
  them in rank order, as it does the sampled x's and the probes' outputs;
- an optional ``build(device)`` builds what the port builds at first use,
  once, in rank 0's process before the other ranks start.
"""

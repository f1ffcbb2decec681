"""The plain reference that decides ``correct``: NumPy, SciPy and plain
PyTorch operations (``torch.sparse`` CSR products), imports nothing of the
port.  Its modules are found by name: ``<driver>.py`` is the plain solver
of a driver, ``prec_<kind>.py`` the plain preconditioner of a mix."""

"""One run of one cell: set-up, the measured window, the traced stretch and
per-layer readers (``--trace 1``), then the comparison with the plain
reference that decides ``correct``.

The order follows what each number needs: the window closes, the device's
memory peak is read, the per-layer readers run, the program's outputs that
the reference judges are copied to the host, the program's state is freed,
and only then does the reference run on the device, so that it sets no
peak and costs no set-up time.
"""
from __future__ import annotations

import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from kkbench import devtrace, ranks, yardstick
from kkbench.reference import csr
from kkbench.registry import Registry

FORBIDDEN = ("jax", "jaxlib", "flax", "tpukk")
_DTYPES = {"float32": torch.float32, "float64": torch.float64}


class NoDevice(RuntimeError):
    pass


def process_age_s() -> float:
    """Seconds since this process started (Linux), at clock-tick resolution."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the run may not hold, compared
    whole (``tpukk_torch`` is not ``tpukk``)."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def log(*a) -> None:
    # one write a line: the ranks share standard error
    sys.stderr.write(" ".join(["kkbench:", *map(str, a)]) + "\n")
    sys.stderr.flush()


def card_state() -> str:
    """The card's name, power limit and clocks, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()


def concat_parts(parts) -> dict:
    """The ranks' CSR arrays (global columns) as one matrix, in rank order."""
    row_maps, start = [parts[0]["row_map"][:1]], 0
    for p in parts:
        row_maps.append(p["row_map"][1:] + start)
        start += int(p["row_map"][-1])
    return {"row_map": torch.cat(row_maps), "entries": torch.cat([p["entries"] for p in parts]),
            "values": torch.cat([p["values"] for p in parts]),
            "nrows": sum(p["nrows"] for p in parts), "ncols": parts[0]["ncols"], "row0": 0}


def csr_times(arrays: dict, X: torch.Tensor) -> torch.Tensor:
    """A·X from CSR arrays, each row summed over its entries in their stored
    order by elementwise operations alone: a row's sums do not depend on
    the other rows, so the rows of a part come out as the whole's do."""
    rm = arrays["row_map"].to(torch.int64)
    ent, vals = arrays["entries"].to(torch.int64), arrays["values"]
    first, length = rm[:-1], rm[1:] - rm[:-1]
    out = torch.zeros((first.shape[0], X.shape[1]), dtype=X.dtype, device=X.device)
    zero = torch.zeros((), dtype=vals.dtype, device=vals.device)
    for k in range(int(length.max()) if first.numel() else 0):
        live = length > k
        j = torch.where(live, first + k, 0)
        out += torch.where(live, vals[j], zero)[:, None] * X[ent[j]]
    return out


class Reservoir:
    """A sample of k solves drawn from the seed, whatever their number."""

    def __init__(self, k: int, seed: int):
        self.k, self.rng, self.seen, self.items = k, np.random.default_rng([seed, 7]), 0, []

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


class Inputs:
    """The cell's matrix and right-hand sides.  The same arrays go to the
    port and, as host copies taken before the port sees them, to the
    reference.

    The mix fixes the set of systems: a pool of ``rhs_pool`` right-hand
    sides b = A·x̂, x̂ drawn from the mix's ``rhs_seed``, since a GMRES
    solve's iterations vary by half from one b to another.  ``--seed``
    draws the order in which the caller solves them (a fresh permutation of
    the pool each round) and the probe vectors, so every seed's window does
    the same work in another order.

    ``part`` is None on one card.  Over several ranks it is (rank, size):
    the rank's rows of the matrix (``build_part`` in ``matrices/``, columns
    global), of every b and of the probes; or (None, size): the whole
    matrix, the parts concatenated in rank order, which rank 0 judges.
    Every rank draws the whole x̂ and the whole probes alike, and sums each
    row of b on its own (``csr_times``), so a rank's rows of b are those of
    the whole b, bit for bit."""

    def __init__(self, reg: Registry, cfg: dict, mix: dict, seed: int, dev, part=None):
        self.dtype = _DTYPES[cfg["dtype"]]
        if part is None:
            arrays = reg.builder(cfg).build(cfg, dev)
        elif part[0] is None:
            arrays = concat_parts([reg.builder(cfg).build_part(cfg, dev, r, part[1])
                                   for r in range(part[1])])
        else:
            arrays = reg.builder(cfg).build_part(cfg, dev, *part)
        self.host = {k: (v.cpu().numpy().copy() if isinstance(v, torch.Tensor) else v)
                     for k, v in arrays.items()}
        self.A = csr.from_arrays(self.host)
        self.n = self.A.shape[0]
        self.P = int(mix["rhs_pool"])
        g = torch.Generator(device=dev)
        g.manual_seed(int(mix["rhs_seed"]))
        if part is None:
            At = csr.to_torch(self.A, dev, self.dtype)
            xhat = torch.randn((self.n, self.P), generator=g, device=dev, dtype=self.dtype)
            # b = A·x̂ for each x̂ of the pool (HPCG's own b is A·1)
            self.B = torch.mm(At, xhat).T.contiguous()
            del At, xhat
        else:
            xhat = torch.randn((self.A.shape[1], self.P), generator=g, device=dev,
                               dtype=self.dtype)
            self.B = csr_times(arrays, xhat).T.contiguous()
            del xhat
        g.manual_seed(seed % 2**63)
        self.x_probe = self._rows(torch.randn(self.A.shape[1], generator=g, device=dev,
                                              dtype=self.dtype))
        self.r_probe = self._rows(torch.randn(self.A.shape[1], generator=g, device=dev,
                                              dtype=self.dtype))
        self._rng = np.random.default_rng([seed, 3])
        self._order = []
        self.arrays = arrays

    def _rows(self, v: torch.Tensor) -> torch.Tensor:
        """This part's rows of a whole vector."""
        if v.shape[0] == self.n:
            return v
        lo = int(self.host["row0"])
        return v[lo:lo + self.n].clone()

    def rhs_index(self, i: int) -> int:
        """The pool index of the i-th solve of the run."""
        while len(self._order) <= i:
            self._order.extend(self._rng.permutation(self.P).tolist())
        return self._order[i]

    def rhs(self, i: int) -> torch.Tensor:
        return self.B[self.rhs_index(i)]

    def device_arrays(self, dev) -> dict:
        """A fresh device copy of the matrix arrays (for a ring of copies)."""
        return {k: (torch.from_numpy(v).to(dev) if isinstance(v, np.ndarray) else v)
                for k, v in self.host.items()}


class Context:
    """What a per-layer reader reads: the window's solves, the traced
    stretch, the second set-up's seconds (``prep_s``), and timed operations
    on the cell's matrix.

    Over several ranks every rank runs every reader in the same order, on a
    context of its own, so that an operation a reader times or a solve it
    makes runs on all ranks in step; rank 0 keeps the values.  ``whole``
    gives rank 0 the whole matrix's inputs."""

    def __init__(self, window, trace, prep_s, driver, state, inputs, mix, cfg, dev, team=None,
                 whole=None):
        self.window, self.trace, self.prep_s = window, trace, prep_s
        self._driver, self._state, self._inputs = driver, state, inputs
        self._mix, self._cfg, self._dev = mix, cfg, dev
        self._team, self._whole = team, whole
        self.peak_bytes_per_s = (yardstick.peak_bytes_per_s(torch.cuda.get_device_name(dev))
                                 if dev.type == "cuda" else None)

    def compulsory_bytes(self, kind: str) -> int:
        A = self._inputs.A if self._team is None else self._whole().A
        return self._bytes(A, kind)

    def _bytes(self, A, kind: str) -> int:
        return yardstick.spmv_bytes(A) if kind == "spmv" else yardstick.PREC_BYTES[self._mix["prec"]](A)

    def _ring(self, kind: str, R: int) -> list:
        """The state's operation and R − 1 copies of it on fresh copies of
        the matrix."""
        d, inp = self._driver, self._inputs
        ops = [self._state.Ah if kind == "spmv" else self._state.prec.apply]
        for _ in range(R - 1):
            A = d.load(inp.device_arrays(self._dev), self._dev)
            ops.append(d.make_spmv(A) if kind == "spmv" else d.make_prec(A, self._mix).apply)
        return ops

    def _calls(self, ops) -> tuple:
        g = torch.Generator(device=self._dev)
        g.manual_seed(1)
        inp = self._inputs
        xs = [torch.randn(inp.n, generator=g, device=self._dev, dtype=inp.dtype) for _ in ops]
        outs = [None] * len(ops)

        def call(i):
            def fn():
                outs[i] = ops[i](xs[i])
            return fn

        return [call(i) for i in range(len(ops))], xs, outs

    def slope_s(self, kind: str):
        """Seconds per call of the SpMV or the preconditioner apply, on a
        ring of copies of its inputs that keeps the L2 cold; None off the
        card.  Over several ranks every rank times its own ring of copies
        of its part, all calling in step, and the slowest rank's slope is
        the call's."""
        if self._dev.type != "cuda":
            return None
        if self._team is not None:
            return self._slope_ranks(kind)
        ops = self._ring(kind, yardstick.ring_size(self.compulsory_bytes(kind)))
        calls, xs, outs = self._calls(ops)
        t = yardstick.slope_seconds(calls)
        del ops, xs, outs, calls
        torch.cuda.empty_cache()
        return t

    def _slope_ranks(self, kind: str) -> float:
        team = self._team
        R = int(team.max(yardstick.ring_size(self._bytes(self._inputs.A, kind))))
        ops = self._ring(kind, R)
        calls, xs, outs = self._calls(ops)
        t, method = yardstick.slope_seconds_ranks(calls, team)
        del ops, xs, outs, calls
        torch.cuda.empty_cache()
        slowest = team.max(t)
        if team.rank == 0:
            log(f"{kind}: {method} over {team.size} ranks, ring of {R}, slope {slowest:.6e} s "
                f"(rank 0 {t:.6e} s)")
        return slowest

    def roofline_pct(self, kind: str):
        """Compulsory bytes over the peak, over the call's time.  Over c
        cards, the whole matrix's bytes over c times the card's peak; None
        on ranks other than 0."""
        if self.peak_bytes_per_s is None:
            return None
        t = self.slope_s(kind)
        if t is None:
            return None
        if self._team is None:
            return 100.0 * self.compulsory_bytes(kind) / self.peak_bytes_per_s / t
        if self._team.rank != 0:
            return None
        return (100.0 * self.compulsory_bytes(kind)
                / (self._team.size * self.peak_bytes_per_s) / t)


def judge(reg: Registry, inputs: Inputs, mix: dict, cfg: dict, samples, probes, tables, dev,
          compare) -> dict:
    """The numbers that decide ``correct``, worked out by the plain
    reference in the configuration's precision.  ``samples`` are (solve
    index, x, iterations) of finished solves; ``probes`` the side's SpMV
    of ``x_probe`` and preconditioner apply of ``r_probe``; ``tables`` what
    its set-up derived (host arrays)."""
    dt = inputs.dtype
    At = csr.to_torch(inputs.A, dev, dt)
    prec_ref = reg.reference(f"prec_{mix['prec']}").Reference(inputs.A, tables, dev, dt)
    out = {}
    out["relres"] = max(csr.rel_residual(At, inputs.rhs(i), x.to(dev)) for i, x, _ in samples)
    if "iters_gap" in compare:
        solver = reg.reference(mix["driver"])
        gaps = []
        for i, _, its in samples[:int(mix.get("ref_solves", 1))]:
            _, its_ref, _ = solver.solve(At, inputs.rhs(i), prec_ref.apply, float(cfg["rtol"]), mix)
            gaps.append(abs(its - its_ref) / its_ref)
        out["iters_gap"] = max(gaps)
    y_ref = torch.mv(At, inputs.x_probe)
    scale = torch.mv(torch.abs(At), torch.abs(inputs.x_probe))
    y = probes["spmv"].to(dev, dt)
    out["spmv_gap"] = float((torch.abs(y - y_ref) / scale.clamp_min(torch.finfo(dt).tiny)).max())
    z_ref = prec_ref.apply(inputs.r_probe)
    z = probes["prec"].to(dev, dt)
    out["prec_gap"] = float(torch.abs(z - z_ref).max() / torch.abs(z_ref).max())
    out.update(prec_ref.judge(tables))
    return {k: (v if math.isfinite(v) else float("inf")) for k, v in out.items()}


class Forbidden(RuntimeError):
    """A rank's process holds a module the run may not hold."""


def run(workload: str, seed: int, seconds: float, trace: bool, reg: Registry | None = None,
        device=None) -> dict:
    """One run; returns the result object.  ``device=None`` takes CUDA
    device 0 and raises ``NoDevice`` without enough cards; tests pass a CPU
    device to drive the rest of a run.  A cell of c > 1 chips runs here as
    rank 0 and on c − 1 spawned ranks (``ranks.py``), one a card; on the
    CPU, c processes."""
    reg = reg or Registry()
    w = reg.workload(workload)
    chips = int(w["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            raise NoDevice(f"kkbench: {workload} needs {w['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
        log(card_state())
    dev = torch.device(device)
    if chips == 1:
        return _side(reg, workload, seed, seconds, trace, dev, None)
    driver = reg.driver(reg.mix(w["traffic"]))
    if hasattr(driver, "build"):
        driver.build(dev)  # once, before the ranks load what it built
    with ranks.start(chips, dev, follow, (reg, workload, seed, seconds, trace)) as team:
        return _side(reg, workload, seed, seconds, trace, dev, team)


def follow(team, reg: Registry, workload: str, seed: int, seconds: float, trace: bool) -> None:
    """A rank other than 0: the same run in step with rank 0, which decides
    when the window closes and reports."""
    _side(reg, workload, seed, seconds, trace, team.device, team)


def _side(reg: Registry, workload: str, seed: int, seconds: float, trace: bool, dev,
          team) -> dict | None:
    """One rank's part of a run (``team`` None: the one card's).  Returns
    the result on rank 0."""
    w = reg.workload(workload)
    cfg, mix, limits = reg.config(w["config"]), reg.mix(w["traffic"]), reg.limits(workload)
    driver = reg.driver(mix)
    tag = "" if team is None else f"rank {team.rank}: "

    inputs = Inputs(reg, cfg, mix, seed, dev, None if team is None else (team.rank, team.size))
    A = driver.load(inputs.arrays, dev)
    inputs.arrays = None
    # the first set-up also loads the kernels; prep_s, read in the traced
    # run, times a second one from the same matrix
    t = time.perf_counter()
    state = driver.prepare(A, cfg, mix)
    _sync(dev)
    first_prep_s = time.perf_counter() - t
    prep_s = None
    if trace:
        t = time.perf_counter()
        state = driver.prepare(A, cfg, mix)
        _sync(dev)
        prep_s = time.perf_counter() - t
    driver.solve(state, inputs.B[0])  # every shape of the window, once
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    log(f"{tag}{workload}: n={inputs.n} nnz={inputs.A.nnz} first set-up {first_prep_s:.4f} s, "
        f"second {prep_s} s")

    setup_s = process_age_s()
    sample = Reservoir(int(mix.get("samples", 8)), seed)
    window = []
    t_start = t_end = time.perf_counter()
    if team is None:
        while t_end - t_start < seconds:
            i = len(window)
            t0 = time.perf_counter()
            x, its, ok = driver.solve(state, inputs.rhs(i))
            _sync(dev)
            t_end = time.perf_counter()
            window.append({"s": t_end - t0, "iters": its, "ok": bool(ok)})
            sample.offer((i, x, its))
    else:
        # rank 0 closes the window and tells the others before each solve;
        # a solve ends when every rank has synchronised its card
        while team.go(t_end - t_start < seconds):
            i = len(window)
            t0 = time.perf_counter()
            x, its, ok = driver.solve(state, inputs.rhs(i))
            _sync(dev)
            ok = team.all(bool(ok))
            t_end = time.perf_counter()
            window.append({"s": t_end - t0, "iters": its, "ok": ok})
            sample.offer((i, x, its))
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_solves = len(window)
    failed = sum(not r["ok"] for r in window)
    its = [r["iters"] for r in window]
    log(f"{tag}{workload}: {n_solves} solves in {window_s:.3f} s, iterations {min(its)}-{max(its)} "
        f"(mean {sum(its) / n_solves:.2f}), failed {failed}")

    result = {"correct": None, "attempted": n_solves, "failed": failed}
    metrics, device_info, breakdown = {}, {}, None
    whole = None if team is None else _Whole(reg, cfg, mix, seed, dev, team.size)
    if not trace:
        times = [r["s"] for r in window]
        values = {"solve_ms": window_s / n_solves * 1e3, "setup_s": setup_s}
        if n_solves >= 2:
            values["solve_p90_ms"] = statistics.quantiles(times, n=10)[-1] * 1e3
        for m in reg.end_to_end(workload):
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        k = int(mix.get("trace_solves", 1))

        def stretch():
            its = 0
            for j in range(k):
                _, it, _ = driver.solve(state, inputs.rhs(n_solves + j))
                its += it
            return its

        tr = devtrace.traced(stretch, dev)
        tr["iters"] = tr.pop("result")
        if team is not None:
            tr = _busy_over_ranks(tr, team)
        ctx = Context(window, tr, prep_s, driver, state, inputs, mix, cfg, dev, team, whole)
        for m in reg.per_layer(workload):
            v = reg.metric_reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if "busy_s" in tr:
            device_info.update(busy_s=tr["busy_s"], window_s=tr["trace_window_s"])
            if "busy_s_by_rank" in tr:
                device_info["busy_s_by_rank"] = tr["busy_s_by_rank"]
            breakdown = tr["breakdown"]

    # the program's outputs that the reference judges, then its state goes
    samples = [(i, x.detach().cpu(), its) for i, x, its in sorted(sample.items,
                                                                   key=lambda s: s[0])]
    probes = {"spmv": state.Ah(inputs.x_probe).cpu(), "prec": state.prec.apply(inputs.r_probe).cpu()}
    tables = {k: f() for k, f in state.tables.items()}
    del state, A, sample
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    peaks = None
    if team is not None:
        # the window has closed: what each rank holds, and its outputs, to rank 0
        every = team.gather({"samples": samples, "probes": probes, "tables": tables,
                             "peak": int(peak), "forbidden": forbidden_modules()})
        team.leave()
        if team.rank != 0:
            return None
        bad = {r: e["forbidden"] for r, e in enumerate(every) if e["forbidden"] and r > 0}
        if bad:
            raise Forbidden(f"kkbench: rank processes hold {bad}: no result")
        samples, probes, tables = _joined(every)
        peaks = [e["peak"] for e in every]
        peak = max(peaks)
        t = time.perf_counter()
        inputs = whole()
        log(f"the whole matrix's inputs in {time.perf_counter() - t:.3f} s")
    t = time.perf_counter()
    numbers = judge(reg, inputs, mix, cfg, samples, probes, tables, dev, limits)
    if team is not None:
        log(f"judged in {time.perf_counter() - t:.3f} s")

    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    result["correct"] = bool(failed == 0 and all(c["value"] <= c["limit"] for c in checks.values()))
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                        "count": int(w["chips"]), "memory_peak_bytes": int(peak), **device_info}
    if peaks is not None:
        result["device"]["memory_peak_bytes_by_rank"] = peaks
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result


class _Whole:
    """The whole matrix's inputs on rank 0 of a multi-rank run, built from
    every rank's part once it is first asked for (the rooflines' bytes, the
    judge), after the window."""

    def __init__(self, reg, cfg, mix, seed, dev, size: int):
        self._args = (reg, cfg, mix, seed, dev, (None, size))
        self._inputs = None

    def __call__(self) -> Inputs:
        if self._inputs is None:
            self._inputs = Inputs(*self._args)
            self._inputs.arrays = None
        return self._inputs


def _busy_over_ranks(tr: dict, team) -> dict:
    """Every rank traced its own card over the stretch: the busy seconds and
    the traced window, averaged over the ranks, on rank 0 (its breakdown
    and operations stay its own)."""
    every = team.gather({k: tr[k] for k in ("busy_s", "trace_window_s") if k in tr})
    if every is None or not all("busy_s" in e for e in every):
        return tr
    return dict(tr, busy_s=statistics.fmean(e["busy_s"] for e in every),
                trace_window_s=statistics.fmean(e["trace_window_s"] for e in every),
                busy_s_by_rank=[e["busy_s"] for e in every])


def _joined(every: list) -> tuple:
    """The ranks' outputs as the whole's: each sampled solve's x, each probe
    and each table (an array of the rank's rows) concatenated in rank order."""
    samples = [(i, torch.cat([e["samples"][j][1] for e in every]), its)
               for j, (i, _, its) in enumerate(every[0]["samples"])]
    probes = {k: torch.cat([e["probes"][k] for e in every]) for k in every[0]["probes"]}
    tables = {k: np.concatenate([np.asarray(e["tables"][k]) for e in every])
              for k in every[0]["tables"]}
    return samples, probes, tables

"""Time the AMG cycle's ELL kernel on every table of the S1-U n=800
hierarchy, against an older version of it and against build variants, on
the card.

    python3 scripts/tune_torch_amg.py --save-before DIR [--commit REV]
        (no card: writes REV's csrc/amg_ell.cu into DIR with ``git show``;
        DIR should be one that .gitignore lists, such as _checkout/before)
    python3 scripts/tune_torch_amg.py [--before DIR] [--variants "D=V,... ..."]
        [--lanes] [--n 800] [--launches 20] [--reps 10]

Builds ``phifem_tpu_torch/csrc/amg_ell.cu`` as shipped, once per
``--variants`` entry (``-D`` defines over the source's macros, such as
``PHIFEM_AMG_CHUNK=4`` or ``PHIFEM_AMG_MIN_BLOCKS=1``) and the source in
``--before`` as it is
(the C interface before group sizes: no ``lanes`` argument, modes 0-2),
one nvcc each, all at once.  It then builds the S1-U hierarchy of
``chip_smoke.py``'s scale run (the perturbed mesh at ``--n``,
``amg_preconditioner()``), lists each table's rows, width and group size
(``cuda_amg.lanes_for``), and

* holds every build bit for bit (``torch.equal``) against the plain
  version on every table in each mode it takes (the operator: apply,
  residual, Jacobi; R: apply; P: apply and, but in the older version, apply
  with the prolongation's add), float32 and float64, at the table's group
  size and, with ``--lanes``, at every group size;
* times every launch of the V-cycle in float32, the cycle's dtype (the
  operator's residual and Jacobi sweep, R, and P with its add: the older
  version's apply followed by PyTorch's add), each build in turns (older,
  shipped, variants, then the reverse order), as device ms per launch from
  a CUDA graph of ``--launches`` launches replayed ``--reps`` times, the L2
  warm as the cycle finds it, beside the byte bound (the nonzeros' values
  and int32 columns once, the vectors) and the launch floor (the same
  kernel and mode on a 1-row, width-1 table);
* with ``--lanes``, times the shipped build at every group size on every
  table;
* times level 0's operator (Jacobi, apply, residual) and R with the L2
  flushed before each launch, float32 and float64, every build in turns:
  ``chip_smoke._device_ms``'s device time per launch (the profiler's, with
  its guard; a time it took from CUDA events instead is printed with an
  ``e``), the flush a 64 MB write (as ``chip_smoke.py``: it leaves the L2
  full of dirty lines, which the kernel's reads must write back) or a
  64 MB read (clean lines); with ``--lanes`` also the shipped build at
  every group size;
* holds one V-cycle as the older version composes it (a Jacobi sweep from
  zero, the prolongation's apply, then the add) against the shipped
  ``AMG.__call__`` by ``torch.equal`` and times both in CUDA graphs, with
  the sum of each one's ELL launches.

Prints the card's name and power limit and one line per case.  The older
source comes from git, so write it first in a checkout
(``python3 scripts/tune_torch_amg.py --save-before _checkout/before``) and
copy the tree with it to the card's machine, there to run
``python3 scripts/tune_torch_amg.py --before _checkout/before``.  The
measuring helpers (CUDA graphs, the profiler, the bounds, the tables) are
``chip_smoke.py``'s, and the composed V-cycle is
``tests/test_torch_amg.py``'s.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))

sys.path.insert(0, str(HERE / "tests"))

import chip_smoke as cs  # noqa: E402
from phifem_tpu_torch.ops import cuda_amg as ca, nvcc_build  # noqa: E402
from test_torch_amg import composed_cycle  # noqa: E402

NAMES = cs.AMG_MODE_NAMES


def _binder(path: str, old: bool):
    """A sweep function over the library at ``path``: ``sweep(mode, cols,
    vals, x, b, d, lanes)`` returns a new y; the older interface has no
    ``lanes`` and no prolongation's add (its P is an apply, then an add)."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    fn = lib.phifem_amg_ell_sweep
    fn.argtypes = [vp] * 6 + [ci] * (5 if old else 6) + [vp]
    fn.restype = ci

    def sweep(mode, c, v, x, b=None, d=None, lanes=None):
        if old and mode == ca.PROLONG_ADD:
            return b + sweep(ca.APPLY, c, v, x)
        w, n = c.shape
        y = torch.empty(n, dtype=x.dtype, device=x.device)
        args = [c.data_ptr(), v.data_ptr(), x.data_ptr(), None if b is None else b.data_ptr(),
                None if d is None else d.data_ptr(), y.data_ptr(), n, w, x.shape[0], mode]
        if not old:
            args.append(ca.lanes_for(n, w) if lanes is None else lanes)
        err = fn(*args, x.dtype == torch.float64, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{path}: launch failed, CUDA error {err}")
        return y

    return sweep


def _ms(t: float) -> str:
    """A time from ``chip_smoke._device_ms``, with an ``e`` after it when
    it came from CUDA events around single calls, not from the trace."""
    return f"{t:.4f}" + ("e" if isinstance(t, cs._EventsMs) else "")


def _modes(label: str, old: bool) -> tuple:
    if label.endswith("A"):
        return ca.APPLY, ca.RESIDUAL, ca.JACOBI
    if label.endswith("R"):
        return (ca.APPLY,)
    return (ca.APPLY,) if old else (ca.APPLY, ca.PROLONG_ADD)


def _hierarchy(n: int):
    import phifem_tpu_torch as pt

    t0 = time.perf_counter()
    s, _, _ = cs._u_scheme(pt, "s1", cs._u_mesh(pt, n, "cuda"), 0.49)
    s.assemble()
    amg = s.amg_preconditioner().amgs["u"]
    torch.cuda.synchronize()
    print(f"[hierarchy] S1-U n={n}: {len(amg.levels)} levels in {time.perf_counter() - t0:.1f} s")
    return amg


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save-before")
    ap.add_argument("--commit", default="05e3a83")
    ap.add_argument("--before")
    ap.add_argument("--variants", default="")
    ap.add_argument("--lanes", action="store_true")
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--launches", type=int, default=20)
    ap.add_argument("--reps", type=int, default=10)
    a = ap.parse_args()
    if a.save_before:
        out = Path(a.save_before)
        out.mkdir(parents=True, exist_ok=True)
        src = subprocess.run(["git", "show", f"{a.commit}:phifem_tpu_torch/csrc/amg_ell.cu"], cwd=HERE,
                             capture_output=True, text=True, check=True).stdout
        (out / "amg_ell.cu").write_text(src)
        print(f"wrote {a.commit}'s amg_ell.cu to {out}")
        return 0
    if not torch.cuda.is_available():
        print("tune_torch_amg: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[device] {smi}")

    jobs = {"shipped": (ca.SOURCE, ())}
    for v in a.variants.split():
        jobs[v] = (ca.SOURCE, tuple(f"-D{kv}" for kv in v.split(",")))
    if a.before:
        jobs["before"] = (Path(a.before) / ca.SOURCE.name, ())
    built = {}
    threads = [threading.Thread(target=lambda k=k, j=j: built.__setitem__(k, nvcc_build.build(*j)))
               for k, j in jobs.items()]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for k in jobs:
        if k not in built:
            raise RuntimeError(f"{k}: the build failed")
        regs = re.findall(r"Compiling entry function '\w+amg_ell_kernelI([fd])Li(\d)ELi(\d+)EE\w*'.*?"
                          r"(\d+) bytes spill stores.*?Used (\d+) registers", built[k]["log"], re.S)
        print(f"[build] {k}: {built[k]['path']} in {built[k]['seconds']:.2f} s; registers (spill bytes) by type, "
              "mode / lanes: " + (", ".join(f"{t}{m}/{g} {r} ({sp})" for t, m, g, sp, r in regs)
                                  or "(already built)"))
    print(f"[build] all in {time.perf_counter() - t0:.2f} s")
    names = (["before"] if a.before else []) + [k for k in jobs if k != "before"]
    sweeps = {k: _binder(built[k]["path"], k == "before") for k in names}

    amg = _hierarchy(a.n)
    rng = np.random.default_rng(1)
    vec = lambda n, dt: torch.as_tensor(rng.standard_normal(n), dtype=dt, device="cuda")
    for label, c, v, n_x, lanes, _ in cs._ell_tables(amg):
        w, n = c.shape
        print(f"[table] {label}: {n} rows x width {w}, {int((c < n_x).sum())} nonzeros, over {n_x} columns, "
              f"{lanes} lanes per row")

    # bits
    nbad = checked = 0
    for dt in (torch.float32, torch.float64):
        for label, c, v, n_x, lanes_t, lvl in cs._ell_tables(amg):
            v = v.to(dt)
            x, b, d = vec(n_x, dt), vec(c.shape[1], dt), lvl.jac_diag.to(dt)
            for k, sweep in sweeps.items():
                for mode in _modes(label, k == "before"):
                    if mode == ca.JACOBI and n_x != c.shape[1]:
                        continue
                    want = ca.amg_ell_sweep_ref(mode, c, v, x, b, d)
                    for lanes in ca.LANES if a.lanes and k != "before" else (lanes_t,):
                        got = sweep(mode, c, v, x, b, d, lanes)
                        torch.cuda.synchronize()
                        checked += 1
                        if not torch.equal(got, want):
                            nbad += 1
                            print(f"[bits] {k} {label} {NAMES[mode]} {dt} lanes {lanes}: max|d| "
                                  f"{float((got - want).abs().max()):.3e}")
    print(f"[bits] {checked} cases against the plain version: {nbad} differences")

    # every launch of the V-cycle, warm, through CUDA graphs
    dt = amg.dtype
    one = torch.ones(1, dtype=dt, device="cuda")
    c1 = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    sums = {k: 0.0 for k in names}
    for label, c, v, n_x, lanes, lvl in cs._ell_tables(amg):
        if label.endswith("A") and lvl.r_cols is None:
            continue
        w, n = c.shape
        nnz = int((c < n_x).sum())
        x, b = vec(n_x, dt), vec(n, dt)
        cyc = ((ca.RESIDUAL, ca.JACOBI) if label.endswith("A") else (ca.APPLY,) if label.endswith("R")
               else (ca.PROLONG_ADD,))
        for mode in cyc:
            d = lvl.jac_diag if mode == ca.JACOBI else None
            ms = {k: [] for k in names}
            for order in (names, names[::-1]):
                for k in order:
                    ms[k].append(cs._graph_ms(lambda: sweeps[k](mode, c, v, x, b, d, lanes), a.launches, a.reps))
            bound = cs._ell_bound(mode, nnz, n, n_x, dt)[0]
            for k in names:
                floor = cs._graph_ms(lambda: sweeps[k](mode, c1, one[None], one, one, one, lanes), a.launches,
                                  a.reps)
                best = min(ms[k])
                sums[k] += best
                print(f"[time] {label} {NAMES[mode]:11s} {n:7d} x {w:3d} L={lanes:2d} {k:28s} ms "
                      f"{' '.join(f'{t:.4f}' for t in ms[k])} floor {floor:.4f} ({best / floor:.2f}x) bound "
                      f"{bound:.4f} ({bound / best:.1%})")
            if a.lanes:
                per = {g: cs._graph_ms(lambda: sweeps["shipped"](mode, c, v, x, b, d, g), a.launches, a.reps)
                       for g in ca.LANES}
                print(f"[lanes] {label} {NAMES[mode]:11s} shipped at each group size: "
                      + ", ".join(f"{g}: {t:.4f}" for g, t in per.items())
                      + f" (lanes_for: {lanes}, fastest: {min(per, key=per.get)})")
    print("[time] the V-cycle's ELL launches summed (best of each): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in sums.items())
          + ("; the older cycle also runs a Jacobi sweep from zero on each level, not in its sum" if a.before else ""))

    # level 0 with the L2 flushed, the profiler's device time
    lvl = amg.levels[0]
    buf = torch.ones(16 * 2**20, dtype=torch.float32, device="cuda")  # 64 MB > the 50 MB L2
    for dtf in (torch.float32, torch.float64):
        for label, (c, v, lanes), mode in (("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.JACOBI),
                                           ("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.APPLY),
                                           ("A", (lvl.ecols, lvl.evals, lvl.e_lanes), ca.RESIDUAL),
                                           ("R", (lvl.r_cols, lvl.r_vals, lvl.r_lanes), ca.APPLY)):
            v = v.to(dtf)
            n = c.shape[1]
            x, b, d = vec(lvl.n, dtf), vec(n, dtf), lvl.jac_diag.to(dtf)
            bound = cs._ell_bound(mode, int((c < lvl.n).sum()), n, lvl.n, dtf)[0]
            for fk in ("write", "read"):
                flushed = lambda sweep, g: cs._device_ms(lambda: sweep(mode, c, v, x, b, d, g), a.launches,
                                                         "amg_ell_kernel", flush=buf, clean=fk == "read")
                dev = {k: [] for k in names}
                for order in (names, names[::-1]):
                    for k in order:
                        dev[k].append(flushed(sweeps[k], lanes))
                for k in names:
                    print(f"[flushed] L0 {label} {NAMES[mode]:8s} {str(dtf)[6:]:7s} {fk:5s} {k:28s} dev "
                          f"{' '.join(map(_ms, dev[k]))} (bound {bound:.4f}; {bound / min(dev[k]):.1%})")
                if a.lanes and (mode == ca.JACOBI or label == "R"):
                    per = {g: flushed(sweeps["shipped"], g) for g in ca.LANES}
                    print(f"[flushed lanes] L0 {label} {NAMES[mode]} {str(dtf)[6:]} {fk}: "
                          + ", ".join(f"{g}: {_ms(t)}" for g, t in per.items()))

    # one V-cycle: the older composition against the shipped AMG.__call__
    bv = vec(amg.levels[0].n, dt)
    new = amg(bv)
    for k in names:
        old = composed_cycle(amg, 0, bv, sweeps[k])
        torch.cuda.synchronize()
        same = torch.equal(old, new)
        nbad += not same
        print(f"[cycle] the composed V-cycle on {k} = AMG.__call__: {same}")
    cyc = {"AMG.__call__ (shipped)": lambda: amg(bv)}
    cyc.update({f"composed on {k}": (lambda k=k: composed_cycle(amg, 0, bv, sweeps[k])) for k in names})
    ms = {k: [] for k in cyc}
    for order in (list(cyc), list(cyc)[::-1]):
        for k in order:
            ms[k].append(cs._graph_ms(cyc[k], 5, a.reps))
    for k in cyc:
        print(f"[cycle] {k:34s} ms per V-cycle {' '.join(f'{t:.4f}' for t in ms[k])}")
    return 1 if nbad else 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probes the batched block Cholesky kernels B2/B3 and B4 on one CUDA card.

    python3 chol_probe.py [--other LABEL=path/to/block_chol.cu ...] [--phases] [--ncu]
                          [--no-times]

Builds gpy_tpu_torch/csrc/block_chol.cu and each --other source (another
version with the same C interface, e.g. the parent commit's, unpacked
with `git archive` into a git-ignored directory) into
gpy_tpu_torch/_build/, all at once, then prints one JSON line each for:
  - ptxas' registers, shared memory and spills of every kernel instance;
  - the SASS of every kernel (cuobjdump): its instruction count and, for
    every loop (a backward branch), the instructions between its head and
    the branch, by opcode (the whole listing goes to chiprun_out/);
  - with --ncu, ncu's WarpStateStats and SchedulerStats sections on one
    (8, 128, 128) float32 launch, or why ncu did not run;
  - block_chol and block_chol_inv against their plain twins at
    chip_smoke.py's batches and its bad-pivot cases (the source in the
    checkout only);
  - with --phases, timing-only copies of the source (PHASE_COPIES) join
    the --other versions: where a launch's time goes, phase by phase;
  - unless --no-times, times at (C, 128, 128), C = 2, 4, 8, 16, float32
    and float64: the profiler's device time and the event time per call of
    every version's block_chol and block_chol_inv, in turns (others, this,
    this, others reversed), beside batched torch.linalg.cholesky (and, for
    block_chol_inv, solve_triangular after it); then
    batched_chol_inv(version=1) at (C, 1000, 1000) float32 with each
    version's block_chol_inv (not the timing-only copies) in turns (device
    and wall time).
Exits non-zero on a failed check or without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import signal
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as s

OUT_DIR = "chiprun_out"


def tool(name):
    found = shutil.which(name)
    if found:
        return found
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name)
    return path if os.path.exists(path) else None


def build_other(_build, label, src, name="block_chol"):
    """nvcc with the build's own flags into _build/other/<label>/lib<name>.so."""
    out = os.path.join(_build.BUILD_DIR, "other", label)
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, f"lib{name}.so")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src],
                       capture_output=True, text=True)
    s.check(r.returncode == 0, f"nvcc failed on {src}:\n{r.stdout}{r.stderr}")
    return so, r.stdout + r.stderr


# Timing-only copies of the checkout's source (their results are wrong and
# are not checked): three delete phases of the factor's panel loop (in both
# kernels), one puts the twin's IEEE 1 / sqrt back on the pivot chain in
# place of rsqrt; the "inv_" copies, timed for block_chol_inv alone, delete
# phases of its inverse or put the twin's IEEE division back on its
# in-panel chain, with the zeros above X's diagonal as dividends or with
# ones in their place
_CHAIN = "const T inv = rsqrt_t(piv);"
_DIAG_LOOP = "for (int k = 0; k < kNB; ++k) {\n        " + _CHAIN
_NO_DIAG = (_DIAG_LOOP, _DIAG_LOOP.replace("k < kNB", "k < 0"))
_NO_SOLVE = ("if (tid < m) {", "if (tid < 0) {")
_NO_UPDATE = ("if (tid < nt * (nt + 1) / 2) {", "if (tid < 0) {")
_NO_INV_SOLVE = ("if (tid < w) {", "if (tid < 0) {")
_NO_INV_UPDATE = ("if (tid < nr * nc) {", "if (tid < 0) {")
_INV_DIVIDE = [("rdiag[row] = T(1) / e[j];", "rdiag[row] = e[j];"),
               ("x[k] *= rdiag[q0 + k];", "x[k] = x[k] / rdiag[q0 + k];")]
PHASE_COPIES = {
    "no_diagonal_factor": [_NO_DIAG],
    "no_trailing_update": [_NO_UPDATE],
    "load_store_only": [_NO_DIAG, _NO_SOLVE, _NO_UPDATE],
    "ieee_chain": [(_CHAIN, "const T inv = T(1) / sqrt_t(piv);")],
    "inv_factor_only": [_NO_INV_SOLVE, _NO_INV_UPDATE],
    "inv_no_trailing_update": [_NO_INV_UPDATE],
    "inv_ieee_division": _INV_DIVIDE,
    "inv_ieee_division_no_zeros": _INV_DIVIDE + [("if (q0 + k < j) x[k] = T(0);",
                                                  "if (q0 + k < j) x[k] = T(1);")],
}


def phase_copies(src_path, out_dir, copies=None):
    """Write the timing-only copies (PHASE_COPIES unless given) of src_path
    into out_dir: [(label, path)]."""
    src = open(src_path).read()
    os.makedirs(out_dir, exist_ok=True)
    out = []
    for label, subs in (PHASE_COPIES if copies is None else copies).items():
        text = src
        for old, new in subs:
            s.check(text.count(old) == 1, f"{old!r} is not in {src_path} once")
            text = text.replace(old, new)
        path = os.path.join(out_dir, label + ".cu")
        with open(path, "w") as f:
            f.write(text)
        out.append((label, path))
    return out


def ptxas_lines(report):
    return [ln.strip() for ln in report.splitlines()
            if "registers" in ln or "spill" in ln or "Compiling entry" in ln]


_INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")


def parse_sass(text):
    """Per kernel of a `cuobjdump -sass` listing: its instruction count and,
    for each backward branch (a loop), the instructions from the branch's
    target to the branch, by opcode (modifiers dropped)."""
    funcs, cur = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = _INSTR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(3), m.group(4).strip()))
    out = {}
    for fname, ins in funcs.items():
        loops = []
        for addr, op, rest in ins:
            if op == "BRA" and rest.startswith("0x") and int(rest.split()[0], 16) < addr:
                head = int(rest.split()[0], 16)
                body = Counter(o.split(".")[0] for a, o, _ in ins if head <= a <= addr)
                loops.append({"head": hex(head), "branch": hex(addr),
                              "instructions": sum(body.values()),
                              "by_opcode": dict(body.most_common())})
        out[fname] = {"instructions": len(ins),
                      "by_opcode": dict(Counter(o.split(".")[0] for _, o, _ in ins).most_common()),
                      "loops": loops}
    return out


def sass(so, label, prefix="sass", keep=None):
    """parse_sass of `so`; the listing goes to chiprun_out/<prefix>_<label>.txt,
    whole or, with `keep`, only the functions whose names hold one of its
    fragments."""
    cuobjdump = tool("cuobjdump")
    if cuobjdump is None:
        return {"error": "no cuobjdump"}
    r = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True)
    s.check(r.returncode == 0, f"cuobjdump failed: {r.stderr}")
    text = r.stdout
    if keep is not None:
        parts = re.split(r"(?=\n\s*Function : )", text)
        text = "".join(p for p in parts
                       if "Function : " in p and any(k in p.split("\n", 2)[1] for k in keep))
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"{prefix}_{label}.txt"), "w") as f:
        f.write(text)
    return parse_sass(r.stdout)


def run_ncu():
    ncu = tool("ncu")
    if ncu is None:
        return {"ncu": "not on this machine"}
    code = ("import torch, chip_smoke as s; from gpy_tpu_torch.ops import block_chol as bc; "
            "A = s.chol_inputs(8, 128, torch.float32, seed=13); bc.block_chol_cuda(A); "
            "torch.cuda.synchronize()")
    cmd = [ncu, "--section", "WarpStateStats", "--section", "SchedulerStats",
           "-k", "regex:block_chol", "-c", "1", sys.executable, "-c", code]
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        out, _ = p.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out, _ = p.communicate()
        return {"ncu": ncu, "rc": "timed out after 240 s", "tail": out[-3000:]}
    with open(os.path.join(OUT_DIR, "ncu.txt"), "w") as f:
        f.write(out)
    return {"ncu": ncu, "rc": p.returncode, "tail": out[-6000:]}


def launcher(so, label, inv=False):
    """block_chol (or, with `inv`, block_chol_inv) of another build, through
    its C interface."""
    import torch

    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    name = "block_chol_inv" if inv else "block_chol"
    f32, f64 = getattr(lib, name + "_f32"), getattr(lib, name + "_f64")
    for fn in (f32, f64):
        fn.argtypes = [p] * (3 if inv else 2) + [ctypes.c_int, p]
        fn.restype = ctypes.c_int

    def run(A):
        out = [torch.empty_like(A) for _ in range(2 if inv else 1)]
        fn = f32 if A.dtype == torch.float32 else f64
        rc = fn(A.data_ptr(), *(o.data_ptr() for o in out), A.shape[0],
                torch.cuda.current_stream().cuda_stream)
        s.check(rc == 0, f"{label} {name} launch failed: {rc}")
        return tuple(out) if inv else out[0]
    return run


def times(versions, bc, inv=False):
    """Each version's device and event time per call, in turns, and its
    max abs error against the plain twin (B4: L's and L^-1's)."""
    import torch

    plain = bc.block_chol_inv_plain if inv else bc.block_chol_plain
    kernel = s.B4_KERNEL if inv else "block_chol_kernel<"
    library = s.chol_inv_library if inv else torch.linalg.cholesky
    ours = bc.block_chol_inv_cuda if inv else bc.block_chol_cuda

    def err(got, ref):
        if inv:
            return [float((g - r).abs().max()) for g, r in zip(got, ref)]
        return float((got - ref).abs().max())

    rows = []
    order = versions + versions[::-1]
    for dt in (torch.float32, torch.float64):
        for C in s.CHOL_TIME_BATCHES:
            A = s.chol_inputs(C, s.CHOL_BLOCK, dt, seed=5 + C)
            ref = plain(A)
            errs = {label: err(fn(A), ref) for label, fn in versions}
            got = {label: [] for label, _ in versions}
            for label, fn in order:
                ms = s.device_ms(lambda: fn(A), kernel=kernel)[0]
                got[label].append({"device_ms": ms,
                                   "event_ms": s.cuda_ms(lambda: fn(A), reps=50)})
            lib_ms = s.device_ms(lambda: ours(A), lambda: library(A), kernel=kernel)[1]
            rows.append({"kernel": "block_chol_inv" if inv else "block_chol", "C": C,
                         "dtype": str(dt).replace("torch.", ""), **got,
                         "max_abs_err_vs_plain": errs,
                         "library_device_ms": lib_ms,
                         "library_event_ms": s.cuda_ms(lambda: library(A), reps=50)})
            print(json.dumps(rows[-1]), flush=True)
    return rows


def blocked_times(versions_inv, bc):
    """batched_chol_inv(version=1) at (C, 1000, 1000) float32 on the HMC
    model's Grams with each version's B4 as its diagonal-block kernel, in
    turns: device time, wall time and device kernels per call. The version
    is swapped in as the module's `block_chol_inv_cuda`, which
    `block_chol_inv` looks up at each call; a counting call per version
    checks that the swapped-in B4 made every launch."""
    import torch

    m = s.hmc_model(*s.hmc_data(), torch.float32)
    ours = bc.block_chol_inv_cuda
    rows = []
    try:
        for C in s.CHOL_TIME_BATCHES:
            K = s.batch_grams(m, C, seed=21 + C)
            got = {label: [] for label, _ in versions_inv}
            for label, fn in versions_inv:
                calls = []
                bc.block_chol_inv_cuda = lambda A, fn=fn: (calls.append(1), fn(A))[1]
                bc.batched_chol_inv(K, version=1)
                s.check(len(calls) == s.block_columns(),
                        f"{label}: {len(calls)} B4 calls in batched_chol_inv, "
                        f"not {s.block_columns()}")
            for label, fn in versions_inv + versions_inv[::-1]:
                bc.block_chol_inv_cuda = fn
                got[label].append(s.time_blocked(lambda k: bc.batched_chol_inv(k, version=1), K,
                                                 s.B4_KERNEL, per_call=s.block_columns()))
            rows.append({"routine": "batched_chol_inv(version=1)", "C": C, "n": s.HMC_N, **got})
            print(json.dumps(rows[-1]), flush=True)
    finally:
        bc.block_chol_inv_cuda = ours
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH",
                    help="another block_chol.cu with the same C interface")
    ap.add_argument("--phases", action="store_true",
                    help="also time PHASE_COPIES of the checkout's source")
    ap.add_argument("--ncu", action="store_true", help="try ncu on one launch")
    ap.add_argument("--no-times", action="store_true",
                    help="build, ptxas, SASS and the checks only")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chol_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    from gpy_tpu_torch.ops import _build
    from gpy_tpu_torch.ops import block_chol as bc

    smi = s.nvidia_smi_line()
    s.emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})
    others = [o.split("=", 1) for o in args.other]
    if args.phases:
        others += phase_copies(os.path.join(_build.CSRC_DIR, "block_chol.cu"),
                               os.path.join(_build.BUILD_DIR, "phases"))
    with ThreadPoolExecutor(max_workers=1 + len(others)) as ex:
        this = ex.submit(_build.build, "block_chol")
        futures = {label: ex.submit(build_other, _build, label, src) for label, src in others}
        builds = {"this": (os.path.join(_build.BUILD_DIR, "libblock_chol.so"), this.result()),
                  **{label: f.result() for label, f in futures.items()}}
    for label, (path, report) in builds.items():
        s.emit({"phase": "ptxas", "version": label, "lines": ptxas_lines(report)})
        s.emit({"phase": "sass", "version": label, "kernels": sass(path, label)})
    if args.ncu:
        s.emit({"phase": "ncu", **run_ncu()})

    dts = (torch.float32, torch.float64)
    s.emit({"phase": "check",
            "block_chol": [s.check_block_chol(bc, C, dt) for dt in dts
                           for C in s.chol_batches(bc)],
            "block_chol_inv": [s.check_block_chol_inv(bc, C, dt) for dt in dts
                               for C in s.CHOL_INV_BATCHES],
            "nan_isolation": [s.check_nan_isolation(bc, dt) for dt in dts]})
    if not args.no_times:
        versions = [(label, launcher(builds[label][0], label)) for label, _ in others
                    if not label.startswith("inv_")]
        versions.append(("this", bc.block_chol_cuda))
        inv = [(label, launcher(builds[label][0], label, inv=True)) for label, _ in others]
        inv.append(("this", bc.block_chol_inv_cuda))
        s.emit({"phase": "times", "nvidia_smi": smi, "rows": times(versions, bc)})
        s.emit({"phase": "inv_times", "nvidia_smi": smi, "rows": times(inv, bc, inv=True)})
        s.emit({"phase": "blocked_times", "nvidia_smi": smi,
                "rows": blocked_times([v for v in inv if v[0] not in PHASE_COPIES], bc)})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

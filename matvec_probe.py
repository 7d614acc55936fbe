#!/usr/bin/env python3
"""Probes the fused Gram-matvec kernel B5 on one CUDA card.

    python3 matvec_probe.py [--other LABEL=path/to/gram_matvec_fused.cu ...] [--phases]
                            [--chunk-phases LABEL]

Builds gpy_tpu_torch/csrc/gram_matvec_fused.cu and each --other source
(another version with the same C interface, e.g. the parent commit's,
unpacked with `git archive` into a git-ignored directory) into
gpy_tpu_torch/_build/, all at once, then prints one JSON line each for:
  - ptxas' registers, shared memory and spills of every kernel instance;
  - the SASS of every B5 instance (cuobjdump): its instruction count, and
    the loops of the main path's instances (MAIN_PATH_SASS) by opcode
    (their listings go to chiprun_out/);
  - B6 of every other version against this one on N=50,000 inputs, bit for
    bit (torch.equal);
  - with --phases, copies of the source (PHASE_COPIES) join the --other
    versions: phases deleted (results wrong), where a launch's time goes,
    and design alternatives (results right), what each element pays; with
    --chunk-phases LABEL, CHUNK_PHASE_COPIES of the --other LABEL's source
    (the parent's chunk kernel) join them too;
  - at chip_smoke.py's main-path shape (N=50,000, D=4, RBF) for R = 1, 9
    and 16: the profiler's device time per launch of every version, in
    turns (others, this, this, others reversed); each version's error
    against the plain twin; the bounds.
Exits non-zero on a failed check or without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as s
from chol_probe import build_other, phase_copies, ptxas_lines, sass

NAME = "gram_matvec_fused"
TIME_R = (1, 9, 16)
# mangled-name fragments of the main path's instances (family RBF): the
# parent's chunk kernel at R = 9, the register-tile kernel at R = 9, 1, 16
MAIN_PATH_SASS = ("gram_matvec_kernelILi0ELi9EE", s.MAIN_B5_INSTANCE,
                  "gram_matvec_tile_kernelILi0ELi1ELi4E", "gram_matvec_tile_kernelILi0ELi16ELi4E")

# Copies of the checkout's source. Phases deleted (results wrong, not
# checked): K left as r2 (no exponential), K summed into one accumulator
# (no contraction with V), the column tiles' staging only (no K, no
# contraction). Design alternatives (results right): exp2f in place of
# ex2.approx, each thread waiting for its next tile's copies before it
# computes (no overlap). PHASE_COPIES cut the register-tile kernel
# (--phases); CHUNK_PHASE_COPIES cut the chunk kernel `gram_matvec_kernel`,
# the parent's main-path kernel and today's D > 8 path (--chunk-phases
# LABEL: copies of the --other LABEL's source).
_NO_EXP = ("k[q] = k_of_r2_fast<FAM>(r2, vv);", "k[q] = r2;")
_CONTRACTION = "      for (int c = 0; c < RC; ++c) {\n        acc[c] = fmaf(k[0], va[c], acc[c]);"
_NO_CONTRACTION = (_CONTRACTION, "      acc[0] += (k[0] + k[1]) + (k[2] + k[3]);\n"
                   + _CONTRACTION.replace("c < RC", "c < 0"))
_LOAD_ONLY = ("for (int s = 0; s < kSteps; ++s) {", "for (int s = 0; s < 0; ++s) {")
_EXP2F = ("__device__ __forceinline__ float ex2_approx(float x) {\n  float y;",
          "__device__ __forceinline__ float ex2_approx(float x) {\n  return exp2f(x);\n  float y;")
_NO_PREFETCH = ("if (tile + 2 < tiles) issue(tile + 2);",
                "if (tile + 2 < tiles) issue(tile + 2);\n    copy_async_wait();")
PHASE_COPIES = {
    "no_exp": [_NO_EXP],
    "no_contraction": [_NO_CONTRACTION],
    "load_only": [_LOAD_ONLY],
    "exp2f": [_EXP2F],
    "no_prefetch": [_NO_PREFETCH],
}
_CHUNK_NO_EXP = ("kv[a][b] = col_ok ? k_of_r2<FAM>(kv[a][b], vv) : 0.0f;",
                 "kv[a][b] = col_ok ? kv[a][b] : 0.0f;")
_CHUNK_NO_CONTRACTION = ("for (int a = 0; a < kPer; ++a) acc[a][c] = fmaf(kv[a][b], vb, acc[a][c]);",
                         "for (int a = 0; a < kPer; ++a) if (c == 0) acc[a][c] += kv[a][b];")
_CHUNK_R2 = ("      __syncthreads();\n      const int kn = min(kChunk, d - d0);\n"
             "      for (int k = 0; k < kn; ++k) {\n        float xa[kPer], xb[kPer];")
_CHUNK_NO_R2 = ("        }\n      }\n" + _CHUNK_R2,
                "        }\n      }\n" + _CHUNK_R2.replace("min(kChunk, d - d0)", "0"))
CHUNK_PHASE_COPIES = {
    "chunk_no_exp": [_CHUNK_NO_EXP],
    "chunk_no_contraction": [_CHUNK_NO_CONTRACTION],
    "chunk_load_only": [_CHUNK_NO_EXP, _CHUNK_NO_CONTRACTION, _CHUNK_NO_R2],
}


def launchers(so, label):
    """B5 and B6 of a build, through its C interface."""
    import torch

    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.gram_matvec_fused_f32.argtypes = [p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3 + [p]
    lib.gram_matvec_fused_f32.restype = ctypes.c_int
    lib.gram_moments_f32.argtypes = [p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [p]
    lib.gram_moments_f32.restype = ctypes.c_int

    def matvec(Xs, V, v):
        out = torch.empty((Xs.shape[0], V.shape[1]), dtype=torch.float32, device=Xs.device)
        rc = lib.gram_matvec_fused_f32(Xs.data_ptr(), Xs.data_ptr(), v.data_ptr(), V.data_ptr(),
                                       out.data_ptr(), Xs.shape[0], Xs.shape[0], Xs.shape[1],
                                       V.shape[1], 0, torch.cuda.current_stream().cuda_stream)
        s.check(rc == 0, f"{label} gram_matvec_fused launch failed: {rc}")
        return out

    def moments(Xs, G, V, v):
        N, D = Xs.shape
        partial = torch.empty(-(-N // 64) * -(-D // 16) * 17, dtype=torch.float64,
                              device=Xs.device)
        out = torch.empty(D + 1, dtype=torch.float64, device=Xs.device)
        rc = lib.gram_moments_f32(Xs.data_ptr(), G.data_ptr(), V.data_ptr(), v.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(), N, D, G.shape[1], 0,
                                  torch.cuda.current_stream().cuda_stream)
        s.check(rc == 0, f"{label} gram_moments launch failed: {rc}")
        return out
    return matvec, moments


def check_moments(fns):
    """B6 of every other version against this one, bit for bit, on the
    inputs of chip_smoke.time_moments."""
    import torch

    X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, s.ITER_D, 9, seed=12)
    _, _, G, _, _ = s.fused_inputs(s.ITER_N, None, s.ITER_D, 9, seed=13)
    Xs = (X / ls).contiguous()
    v1 = v.reshape(1)
    ref = fns["this"][1](Xs, G, V, v1)
    out = {}
    for label, (_, moments) in fns.items():
        same = bool(torch.equal(moments(Xs, G, V, v1), ref))
        s.check(same, f"gram_moments of {label} differs from this version's")
        out[label] = same
    return {"N": s.ITER_N, "D": s.ITER_D, "R": 9, "bit_for_bit": out, "moments": ref.tolist()}


def times(versions, fm):
    """Each version's device time per launch, in turns, and its error
    against the plain twin, at N=50,000, D=4 for R in TIME_R."""
    import torch

    rows = []
    for R in TIME_R:
        X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, s.ITER_D, R, seed=11)
        Xs = (X / ls).contiguous()
        v1 = v.reshape(1)
        ref = fm.stationary_gram_matvec_plain(Xs, Xs, V, v1, 0)
        scale = float(ref.abs().max())
        err = {}
        for label, fn in versions:
            out = fn(Xs, V, v1)
            torch.cuda.synchronize()
            err[label] = float((out - ref).abs().max()) / scale
        tol = s.FUSED_FWD_TOL_50K[R]
        s.check(err["this"] <= tol, f"gram_matvec_fused R={R}: rel err {err['this']} > {tol}")
        got = {label: [] for label, _ in versions}
        for label, fn in versions + versions[::-1]:
            got[label].append(s.device_ms(lambda: fn(Xs, V, v1), reps=10, warmup=2,
                                          kernel="gram_matvec")[0])
        rows.append({"N": s.ITER_N, "D": s.ITER_D, "R": R, "device_ms": got,
                     "rel_err_vs_plain": err,
                     **s.fused_matvec_bounds(s.ITER_N, s.ITER_N, s.ITER_D, R)})
        s.emit({"phase": "times_row", **rows[-1]})
        del X, V, Xs, ref
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH",
                    help="another gram_matvec_fused.cu")
    ap.add_argument("--phases", action="store_true",
                    help="also time PHASE_COPIES of the checkout's source")
    ap.add_argument("--chunk-phases", metavar="LABEL",
                    help="also time CHUNK_PHASE_COPIES of the --other LABEL's source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matvec_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    from gpy_tpu_torch.ops import _build
    from gpy_tpu_torch.ops import gram_matvec_fused as fm

    smi = s.nvidia_smi_line()
    s.emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})
    others = [o.split("=", 1) for o in args.other]
    if args.chunk_phases:
        others += phase_copies(dict(others)[args.chunk_phases],
                               os.path.join(_build.BUILD_DIR, "matvec_chunk_phases"),
                               CHUNK_PHASE_COPIES)
    if args.phases:
        others += phase_copies(os.path.join(_build.CSRC_DIR, NAME + ".cu"),
                               os.path.join(_build.BUILD_DIR, "matvec_phases"), PHASE_COPIES)
    with ThreadPoolExecutor(max_workers=1 + len(others)) as ex:
        this = ex.submit(_build.build, NAME)
        futures = {label: ex.submit(build_other, _build, label, src, NAME)
                   for label, src in others}
        builds = {**{label: f.result() for label, f in futures.items()},
                  "this": (os.path.join(_build.BUILD_DIR, f"lib{NAME}.so"), this.result())}
    for label, (path, report) in builds.items():
        s.emit({"phase": "ptxas", "version": label, "lines": ptxas_lines(report)})
        kernels = sass(path, label, prefix="sass_matvec", keep=MAIN_PATH_SASS)
        if "error" not in kernels:
            kernels = {k: (v if any(m in k for m in MAIN_PATH_SASS)
                           else {"instructions": v["instructions"]})
                       for k, v in kernels.items() if re.search(r"\dgram_matvec_(tile_|wide_)?kernelI", k)}
        s.emit({"phase": "sass", "version": label, "kernels": kernels})

    fns = {label: launchers(path, label) for label, (path, _) in builds.items()}
    s.emit({"phase": "gram_moments_bit_for_bit", **check_moments(fns)})
    versions = [(label, f[0]) for label, f in fns.items()]
    s.emit({"phase": "times", "nvidia_smi": smi, "rows": times(versions, fm)})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Probes the fused Gram-matvec kernel B5 and its gradient moments B6 on one CUDA card.

    python3 matvec_probe.py [--other LABEL=path/to/gram_matvec_fused.cu ...] [--phases]
                            [--no-times] [--only wide|cross|chunk]
                            [--predict-other LABEL=path/to/checkout ...]
                            [--objective-other LABEL=path/to/checkout ...]

Builds gpy_tpu_torch/csrc/gram_matvec_fused.cu and each --other source
(another version, e.g. the parent commit's, unpacked with `git archive`
into a git-ignored directory; a source whose C interface has no `diag`
argument is called without it) into gpy_tpu_torch/_build/, all at once,
then prints one JSON line each for:
  - ptxas' registers, shared memory and spills of every kernel instance;
  - the SASS of every B5 and B6 instance (cuobjdump): its instruction
    count, and the loops of the main path's instances (MAIN_PATH_SASS) by
    opcode (their listings go to chiprun_out/), with the tensor-core
    instructions (HMMA, HGMMA) of B5's wide instance (R > 16) and of its
    cross-term instance (8 < D <= 64, R <= 16) by their full opcode;
  - B5's wide kernel at chip_smoke.WIDE_SHAPES and at N=50,000, D=4 for R in
    WIDE_R against the plain twin, and a second launch at (4096, 4, 256)
    bit for bit against the first;
  - B5's cross-term kernel at chip_smoke.CROSS_SHAPES for every family
    within FUSED_FWD_TOL, and chip_smoke.check_cross (a second launch bit
    for bit, K_ii exactly v, the sharded slab's rows bit for bit);
  - B6 of every version on N=50,000 inputs against the float64 plain twin
    (within chip_smoke.FUSED_BWD_TOL_50K), and this version's bit for bit
    against a second launch of itself;
  - B6 of every version at chip_smoke.MOMENT_SHAPES for every family on
    positive inputs against the float64 plain twin, and at N=50,000 on
    signed inputs (D=12, R=9 and D=4, R=17: the kernel for D > 8 or R > 16)
    with a second launch; this version held within FUSED_BWD_TOL and
    chip_smoke.MOMENTS_MMA_TOL_50K, bit for bit, the others read;
  - with --phases, copies of the source (PHASE_COPIES for B5's
    register-tile kernel, MOMENTS_PHASE_COPIES for B6, WIDE_PHASE_COPIES for
    B5's wide kernel, timed at R=256, CROSS_PHASE_COPIES for its cross-term
    kernel, timed at D=12, R=9) join the --other versions: phases deleted
    or replaced (results wrong, not checked), where a launch's time goes,
    and design alternatives, what each element pays;
  - unless --no-times, at chip_smoke.py's main-path shape (N=50,000, D=4,
    RBF) for R = 1, 9 and 16 and B5's wide R = 17, 64, 256 and 1024: the
    profiler's device time per launch of every version's B5 and B6 (B6's
    reduce beside it; B6 at R = 1, 9, 16), in turns (others, this, this,
    others reversed); each version's error against the plain twin (B6: the
    float64 one); the bounds. B5 at D > 8 (CROSS_D by TIME_R: this
    version's cross-term kernel, a parent's chunk kernel) the same way, on
    centred inputs (as the wrapper centres them) with the cross-term
    bounds. Then B6 for D > 8 or R > 16 (CHUNK_TIMES: this version's mma
    kernel, a parent's chunk kernel) by device time in turns, each
    version's error against the float64 plain twin, with both bounds;
    --only wide times B5's wide kernel alone with WIDE_PHASE_COPIES, --only
    cross B5 at D > 8 alone with CROSS_PHASE_COPIES, --only chunk B6's mma
    kernel alone with CHUNK_PHASE_COPIES (timed at D=12, R=9);
  - with --predict-other, the fused N=50,000 model's predict at 256 points
    (48 CG launches of B5 at R = 256) by host time, in a fresh process on
    each checkout in turns (others, this, this, others reversed);
  - with --objective-other, the fused N=50,000, D=12 model's NLML+gradient
    (chip_smoke's iterative_d12 model: 49 B5 launches at R = 9 and one B6)
    by host time, in a fresh process on each checkout in turns.
Exits non-zero on a failed check or without a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import chip_smoke as s
from chol_probe import OUT_DIR, build_other, phase_copies, ptxas_lines, sass

NAME = "gram_matvec_fused"
TIME_R = (1, 9, 16)
WIDE_R = (17, 64, 256, 1024)
CROSS_D = (9, 12, 20, 32)
# mangled-name fragments of the main path's instances (family RBF): B5's
# register-tile kernel at R = 9, 1, 16, its wide kernel (R > 16, D <= 4: a
# predict's CG) and the parent's, its cross-term kernel at R = 9 (D > 8: the
# D=12 path's CG) and the chunk kernel it replaced; B6's mma kernel at DMAX
# 12 (the D=12 path's B6), 4 (R > 16) and 0 (D > 12) and the chunk kernel it
# replaced, its register-tile kernel at R = 9, 1, 16
MAIN_PATH_SASS = (s.MAIN_B5_INSTANCE,
                  "gram_matvec_tile_kernelILi0ELi1ELi4E", "gram_matvec_tile_kernelILi0ELi16ELi4E",
                  s.WIDE_B5_INSTANCE, "gram_matvec_wide_kernelILi0EE",
                  s.CROSS_B5_INSTANCE, "gram_matvec_kernelILi0ELi9EE",
                  s.CHUNK_B6_INSTANCE, "gram_moments_mma_kernelILi0ELi4ELi0EE",
                  "gram_moments_mma_kernelILi0ELi0ELi2EE", "gram_moments_kernelILi0EE",
                  s.MAIN_B6_INSTANCE,
                  "gram_moments_tile_kernelILi0ELi1ELi4E", "gram_moments_tile_kernelILi0ELi16ELi4E")
# B6 for D > 8 or R > 16 at N=50,000 (D, R): D = 9, 12, 20, 32 by R = 1, 9,
# 16 (D = 12, R = 9: the D=12 path's one launch an NLML+gradient), and R > 16
CHUNK_TIMES = tuple((D, R) for D in (9, 12, 20, 32) for R in (1, 9, 16)) + ((4, 17), (4, 64))
# the signed N=50,000 checks (chip_smoke.MOMENTS_MMA_TOL_50K)
CHUNK_SIGNED = ((12, 9), (4, 17))
# the profiler's names of B6's kernels: at D=4, R <= 16 the register-tile
# kernel, or the chunk kernel of a source that has none; at D > 8 or R > 16
# the mma kernel, or a parent's chunk kernel
B6_TILE, B6_CHUNK, B6_OLD_CHUNK = s.B6_KERNEL, s.B6_CHUNK_KERNEL, "gram_moments_kernel<"

# Copies of the checkout's source that cut B5's register-tile kernel
# (--phases). Phases deleted (results wrong, not checked): K left as r2 (no
# exponential), K summed into one accumulator (no contraction with V), the
# column tiles' staging only (no K, no contraction). Design alternatives
# (results right): exp2f in place of ex2.approx, each thread waiting for
# its next tile's copies before it computes (no overlap).
_NO_EXP = ("k[q] = k_of_r2_fast<FAM>(r2, vv);", "k[q] = r2;")
_CONTRACTION = "    for (int c = 0; c < RC; ++c) {\n      acc[c] = fmaf(k[0], va[c], acc[c]);"
_NO_CONTRACTION = (_CONTRACTION, "    acc[0] += (k[0] + k[1]) + (k[2] + k[3]);\n"
                   + _CONTRACTION.replace("c < RC", "c < 0"))
_LOAD_ONLY = ("for (int s = 0; s < kSteps; ++s) {", "for (int s = 0; s < 0; ++s) {")
_EXP2F = ("__device__ __forceinline__ float ex2_approx(float x) {\n  float y;",
          "__device__ __forceinline__ float ex2_approx(float x) {\n  return exp2f(x);\n  float y;")
_NO_PREFETCH = ("if (tile + 2 < tiles) issue(tile + 2);\n    const float4* xt",
                "if (tile + 2 < tiles) issue(tile + 2);\n    copy_async_wait();\n    const float4* xt")
PHASE_COPIES = {
    "no_exp": [_NO_EXP],
    "no_contraction": [_NO_CONTRACTION],
    "load_only": [_LOAD_ONLY],
    "exp2f": [_EXP2F],
    "no_prefetch": [_NO_PREFETCH],
}
# Copies that cut B5's cross-term kernel (--phases or --only cross; timed at
# D=12, R=9). cross_simt_r2: the cross term's mma.sync replaced by SIMT
# direct differences of the rows' and columns' coordinates read through L1
# (the tensor-core kernel's D > 8 form), in the same walk (results right
# but for the diagonal's r2 = 0; not checked); cross_no_exp: K left as -r2'
# (no exponential); cross_no_contraction: K summed into one accumulator (no
# contraction with V); cross_no_mma: the accumulators left at -(|x'|^2 +
# |y'|^2) (no tensor-core cross term); cross_no_relayout: each tile's B
# fragments, norms and V rows never re-laid (the first tile's read again).
_CROSS_MMA = """      for (int ks = 0; ks < ks_n; ++ks) {
        float4 ah[MB], al[MB];
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          ah[mb] = *reinterpret_cast<const float4*>(at + (mb * ks_n + ks) * 256);
          al[mb] = *reinterpret_cast<const float4*>(at + (mb * ks_n + ks) * 256 + 128);
        }
#pragma unroll
        for (int s = 0; s < kCrossPass; ++s) {
          const float4 b =
              *reinterpret_cast<const float4*>(bt + ((p * kCrossPass + s) * ks_n + ks) * 128);
#pragma unroll
          for (int mb = 0; mb < MB; ++mb) {
            mma_tf32(c[mb][s], al[mb], b.x, b.y);
            mma_tf32(c[mb][s], ah[mb], b.z, b.w);
            mma_tf32(c[mb][s], ah[mb], b.x, b.y);
          }
        }
      }
"""
_CROSS_SIMT = """#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
      for (int s = 0; s < kCrossPass; ++s) {
        const int64_t ia = wrow + mb * 16 + lane / 4, ib = ia + 8;
        const int64_t ja = col0 + (p * kCrossPass + s) * 8 + 2 * t;
        const float* pa = xs + (ia < n ? ia : n - 1) * d;
        const float* pb = xs + (ib < n ? ib : n - 1) * d;
        const float* qa = x2s + (ja < m ? ja : m - 1) * d;
        const float* qb = x2s + (ja + 1 < m ? ja + 1 : m - 1) * d;
        float r2[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int e = 0; e < d; ++e) {
          const float xa = __ldg(pa + e), xb = __ldg(pb + e);
          const float ya = __ldg(qa + e), yb = __ldg(qb + e);
          const float d0 = xa - ya, d1 = xa - yb, d2 = xb - ya, d3 = xb - yb;
          r2[0] = fmaf(d0, d0, r2[0]);
          r2[1] = fmaf(d1, d1, r2[1]);
          r2[2] = fmaf(d2, d2, r2[2]);
          r2[3] = fmaf(d3, d3, r2[3]);
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) c[mb][s][q] = -r2[q] * (scale * scale);
      }
"""
_CROSS_K = "k[mb][q] = k_of_r2_fast<FAM>(fmaxf(-c[mb][s][q], 0.0f), vv);"
_CROSS_V = "const float* va = vt + ((p * kCrossPass + s) * 8 + 2 * t) * kStride;  // V row 2t"
_CROSS_RELAYOUT = "    if (tile + 1 < tiles) relayout(cur ^ 1, valid(tile + 1));\n"
CROSS_PHASE_COPIES = {
    "cross_simt_r2": [(_CROSS_MMA, _CROSS_SIMT)],
    "cross_no_mma": [(_CROSS_MMA, "")],
    "cross_no_relayout": [(_CROSS_RELAYOUT, "")],
    "cross_no_exp": [(_CROSS_K, "k[mb][q] = -c[mb][s][q];")],
    "cross_no_contraction": [(_CROSS_V, "acc[0][0] += (k[0][0] + k[0][1]) + (k[MB - 1][2] + k[MB - 1][3]);"
                                        "\n        continue;\n        " + _CROSS_V)],
}
# Copies that cut B6's register-tile kernel (--phases; results wrong, not
# checked): the weights left as w r2' and w (no exponential), W' from one
# product in place of R (no contraction with G), and the column tiles'
# staging only (as load_only).
MOMENTS_PHASE_COPIES = {
    "moments_no_exp": [("moment_weights<FAM>(r2, w, wk, wn);", "wk = w * r2;\n      wn = w;")],
    "moments_no_w": [("for (int c = 1; c < RC; ++c) w = fmaf(gq[c], vq[c], w);",
                      "for (int c = 1; c < 0; ++c) w = fmaf(gq[c], vq[c], w);")],
    "moments_load_only": [_LOAD_ONLY],
}


# Copies that cut B6's mma kernel (--phases or --only chunk; timed at D=12,
# R=9, its one-pass instance). mom_ffma_w: W in FFMA on the SIMT cores,
# the thread's rows of v G in registers (R = 9 written in) and V's rows read
# unsplit from the B-fragment tile (results right; the comparison the
# design asks for at R <= 16); mom_no_mma: W left at a sum of its operands
# (no tensor cores); mom_no_exp: the weights left as w r2' and w;
# mom_no_moments: the D moment sums replaced by one of wn r2'; and
# mom_staging_only: the tiles copied, folded and split, nothing computed.
_MOM_MMA = """      mma_tf32(cl, al, b.x, b.y);
      mma_tf32(cl, ah, b.z, b.w);
      mma_tf32(c, ah, b.x, b.y);
"""
_MOM_WSTEP = """  auto w_step = [&](const float* bt, int s, float (&c)[4]) {
    float cl[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    c[0] = c[1] = c[2] = c[3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < ks_n; ++kk) {
      const float4 ah = *reinterpret_cast<const float4*>(at + kk * 256);
      const float4 al = *reinterpret_cast<const float4*>(at + kk * 256 + 128);
      const float4 b = *reinterpret_cast<const float4*>(bt + (s * ks_n + kk) * 128);
""" + _MOM_MMA + """    }
#pragma unroll
    for (int q = 0; q < 4; ++q) c[q] += cl[q];
  };
"""
_MOM_FFMA = """  float gfa[9], gfb[9];  // the thread's rows of v G, R = 9
#pragma unroll
  for (int cc = 0; cc < 9; ++cc) {
    gfa[cc] = (ra < n && cc < rc) ? __fmul_rn(vv, g[ra * r + c0 + cc]) : 0.0f;
    gfb[cc] = (rb < n && cc < rc) ? __fmul_rn(vv, g[rb * r + c0 + cc]) : 0.0f;
  }
  auto w_step = [&](const float* bt, int s, float (&c)[4]) {
    const float* bs = bt - lane * 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float va[16];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const float2 f = *reinterpret_cast<const float2*>(
              bs + ((s * 2 + kk) * 32 + 4 * (2 * t + h) + m) * 4);
          va[kk * 8 + m] = f.x;
          va[kk * 8 + m + 4] = f.y;
        }
      float wa = 0.0f, wb = 0.0f;
#pragma unroll
      for (int cc = 0; cc < 9; ++cc) {
        wa = fmaf(gfa[cc], va[cc], wa);
        wb = fmaf(gfb[cc], va[cc], wb);
      }
      c[h] = wa;
      c[2 + h] = wb;
    }
  };
"""
_MOM_SPLIT = ("      split_tf32(c < rc ? rv[c] : 0.0f, o.x, o.z);\n"
              "      split_tf32(c + 4 < rc ? rv[c + 4] : 0.0f, o.y, o.w);\n",
              "      o = make_float4(c < rc ? rv[c] : 0.0f, c + 4 < rc ? rv[c + 4] : 0.0f, 0.0f, 0.0f);\n")
CHUNK_PHASE_COPIES = {
    "mom_ffma_w": [(_MOM_WSTEP, _MOM_FFMA), _MOM_SPLIT],
    "mom_no_mma": [(_MOM_MMA, "      c[0] += b.x; c[1] += b.y; c[2] += ah.x; c[3] += al.x;\n")],
    "mom_no_exp": [("moment_weights<FAM>(r2, c[2 * q + h], wk, wn);",
                    "wk = c[2 * q + h] * r2;\n            wn = c[2 * q + h];")],
    "mom_no_moments": [("for (int e = 0; e < kDX; ++e) mt[e] = fmaf(wn, dq[e], mt[e]);",
                        "for (int e = 0; e < 1; ++e) mt[e] = fmaf(wn, r2, mt[e]);")],
    "mom_staging_only": [("    if (k + 2 < nt) issue(k + 2);\n    const float* xt",
                          "    if (k + 2 < nt) issue(k + 2);\n    continue;\n    const float* xt")],
}


# Design alternatives of B6's mma kernel (--phases or --only chunk; results
# right, read not checked), each timed beside it at its CHUNK_DESIGN_TIMES:
# mom_ks_runtime, the k-steps of R a runtime count at every R (no KS = 1, 2
# instances); mom_dmax12_at_8, 4 < D <= 8 (R > 16) on the DMAX 12 instance;
# mom_no_split, one column split (grid.y = 1). (4-byte copies straight into
# the compute layout, the kernel before its 16-byte raw copies, are timed as
# an --other source: PERF.md.)
CHUNK_DESIGN_COPIES = {
    "mom_ks_runtime": [("launch_moments_mma<FAM, DMAX, 1>", "launch_moments_mma<FAM, DMAX, 0>"),
                       ("launch_moments_mma<FAM, DMAX, 2>", "launch_moments_mma<FAM, DMAX, 0>")],
    "mom_dmax12_at_8": [("if (d <= 8) return launch_moments_mma<FAM, 8, 0>",
                         "if (d <= 8) return launch_moments_mma<FAM, 12, 0>")],
    "mom_no_split": [("for (int sp = 2; sp <= kMomMaxSplits; ++sp)",
                      "for (int sp = 2; sp <= 1; ++sp)")],
}
# (D, R) at N=50,000 where each design alternative differs from the kept
# kernel: the fixed k-steps (R <= 16, one pass and two), the DMAX 8 instance
# (R > 16, one launch and two), the splits (one pass, two, D <= 4)
CHUNK_DESIGN_TIMES = {
    "mom_ks_runtime": ((12, 1), (12, 9), (12, 16), (20, 9)),
    "mom_dmax12_at_8": ((8, 17), (8, 72)),
    "mom_no_split": ((12, 9), (20, 9), (4, 17)),
}

# Copies of the checkout's source that cut B5's wide kernel (--phases or
# --only wide; timed at R=256 only; results wrong, not checked). Phases
# deleted: K left as r2 (no exponential), the contraction's wgmma replaced
# by one FADD a step, one TF32 pass (hi.hi) in place of three, and V's core
# matrices written without their hi / lo split. A check of the layout: the
# descriptor's two byte offsets swapped (wrong results if the layout is read
# as intended).
_WIDE_PASSES = ("        wgmma_tf32(part, al[s], bh, s > 0);  // a fresh sum at the tile's first step\n"
                "        wgmma_tf32(part, ah[s], bl, 1);\n"
                "        wgmma_tf32(part, ah[s], bh, 1);\n")
_WIDE_VSPLIT = "split_tf32(rv[(8 * s + 4 * ck) * kRawStride + 8 * cn], hi, lo);"
_WIDE_DESC = "constexpr uint64_t kDescLBO = 128 / 16;\nconstexpr uint64_t kDescSBO = 256 / 16;"
WIDE_PHASE_COPIES = {
    "wide_no_exp": [("ka[q] = k_of_r2_fast<FAM>(r2, vv);", "ka[q] = r2;")],
    "wide_no_mma": [(_WIDE_PASSES,
                     "        part[s] += __uint_as_float(al[s][0] ^ ah[s][1] ^ (bh + bl));\n")],
    "wide_one_pass": [(_WIDE_PASSES, "        wgmma_tf32(part, ah[s], bh, s > 0);\n")],
    "wide_no_vsplit": [(_WIDE_VSPLIT, "hi = lo = rv[(8 * s + 4 * ck) * kRawStride + 8 * cn];")],
    "wide_desc_swap": [(_WIDE_DESC, "constexpr uint64_t kDescLBO = 256 / 16;\n"
                                    "constexpr uint64_t kDescSBO = 128 / 16;")],
}


def launchers(so, label, diag_abi, mma_scratch):
    """B5 and B6 of a build, through its C interface; `diag_abi`: B5 takes
    the diagonal's row offset (0 here: every probe product is square);
    `mma_scratch`: B6 takes the mma kernel's scratch (128-double rows, 4 a
    128-row block), else the chunk kernel's (17-double rows a 64-row tile
    and 16-dimension chunk)."""
    import torch

    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    extra = [ctypes.c_int64] if diag_abi else []
    lib.gram_matvec_fused_f32.argtypes = ([p] * 5 + [ctypes.c_int64] * 2 + [ctypes.c_int] * 3
                                          + extra + [p])
    lib.gram_matvec_fused_f32.restype = ctypes.c_int
    lib.gram_moments_f32.argtypes = [p] * 6 + [ctypes.c_int64] + [ctypes.c_int] * 3 + [p]
    lib.gram_moments_f32.restype = ctypes.c_int

    def matvec(Xs, V, v):
        out = torch.empty((Xs.shape[0], V.shape[1]), dtype=torch.float32, device=Xs.device)
        rc = lib.gram_matvec_fused_f32(Xs.data_ptr(), Xs.data_ptr(), v.data_ptr(), V.data_ptr(),
                                       out.data_ptr(), Xs.shape[0], Xs.shape[0], Xs.shape[1],
                                       V.shape[1], 0, *([0] if diag_abi else []),
                                       torch.cuda.current_stream().cuda_stream)
        s.check(rc == 0, f"{label} gram_matvec_fused launch failed: {rc}")
        return out

    def moments(Xs, G, V, v, family=0):
        N, D = Xs.shape
        size = -(-N // 128) * 4 * 128 if mma_scratch else -(-N // 64) * -(-D // 16) * 17
        partial = torch.empty(size, dtype=torch.float64, device=Xs.device)
        out = torch.empty(D + 1, dtype=torch.float64, device=Xs.device)
        rc = lib.gram_moments_f32(Xs.data_ptr(), G.data_ptr(), V.data_ptr(), v.data_ptr(),
                                  partial.data_ptr(), out.data_ptr(), N, D, G.shape[1], family,
                                  torch.cuda.current_stream().cuda_stream)
        s.check(rc == 0, f"{label} gram_moments launch failed: {rc}")
        return out
    return matvec, moments


def has_mma_moments(src):
    """Whether a source's B6 for D > 8 or R > 16 is the mma kernel (its
    scratch and profiler name), not a parent's chunk kernel."""
    return "gram_moments_mma_kernel" in open(src).read()


def has_diag_abi(src):
    """Whether a source's B5 entry point takes the diagonal's row offset."""
    text = open(src).read()
    return "int r, int family, int64_t diag, void* stream" in text


def tensor_core_ops(label, instance):
    """The tensor-core instructions (HMMA, HGMMA) of a B5 instance in a
    version's SASS listing, by full opcode: the route of its cross term or
    contraction."""
    path = os.path.join(OUT_DIR, f"sass_matvec_{label}.txt")
    if not os.path.exists(path):
        return {}
    parts = re.split(r"(?=\n\s*Function : )", open(path).read())
    body = "".join(p for p in parts if "Function : " in p
                   and instance in p.split("Function : ", 1)[1].split("\n", 1)[0])
    return dict(Counter(re.findall(r"\b(HG?MMA[A-Z0-9_.]*)", body)))


def moments_inputs(R):
    """chip_smoke.time_moments' inputs at N=50,000, D=4: scaled X, G, V, v."""
    X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, s.ITER_D, R, seed=12)
    _, _, G, _, _ = s.fused_inputs(s.ITER_N, None, s.ITER_D, R, seed=13)
    return (X / ls).contiguous(), G, V, v.reshape(1)


def moments_errors(fns, fm, inputs):
    """Each version's B6 on `inputs` against the float64 plain twin,
    relative to max|ref|, and this version's result."""
    ref = fm.gram_moments_plain(*(t.double() for t in inputs), 0)
    scale = float(ref.abs().max())
    out = {label: moments(*inputs) for label, moments in fns.items()}
    return {label: float((o - ref).abs().max()) / scale for label, o in out.items()}, out["this"]


def check_moments(fns, fm, unchecked):
    """B6 of every version but the timing-only `unchecked` within
    FUSED_BWD_TOL_50K of the float64 plain twin, and this version's bit for
    bit against a second launch of itself, on chip_smoke.time_moments'
    inputs (R=9)."""
    import torch

    inputs = moments_inputs(9)
    err, first = moments_errors(fns, fm, inputs)
    for label, rel in err.items():
        if label not in unchecked:
            s.check(rel <= s.FUSED_BWD_TOL_50K,
                    f"gram_moments of {label}: rel err {rel} vs float64 > {s.FUSED_BWD_TOL_50K}")
    same = bool(torch.equal(fns["this"](*inputs), first))
    s.check(same, "gram_moments: two launches of this version differ")
    return {"N": s.ITER_N, "D": s.ITER_D, "R": 9, "rel_err_vs_f64_plain": err,
            "rel_tol": s.FUSED_BWD_TOL_50K, "unchecked": sorted(unchecked & set(err)),
            "this_repeats_bit_for_bit": same, "moments": first.tolist()}


def times(versions, fm, rs):
    """Each version's device time per launch, in turns, and its error
    against the plain twin, at N=50,000, D=4 for R in `rs`."""
    import torch

    rows = []
    for R in rs:
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
            got[label].append(s.device_ms(lambda: fn(Xs, V, v1), reps=10 if R <= 256 else 4,
                                          warmup=2, kernel="gram_matvec")[0])
        rows.append({"N": s.ITER_N, "D": s.ITER_D, "R": R, "device_ms": got,
                     "rel_err_vs_plain": err,
                     **s.fused_matvec_bounds(s.ITER_N, s.ITER_N, s.ITER_D, R)})
        s.emit({"phase": "times_row", **rows[-1]})
        del X, V, Xs, ref
        torch.cuda.empty_cache()
    return rows


def wide_checks(fm):
    """This version's B5 wide kernel (R > 16) through the public wrapper:
    chip_smoke's wide shapes for every family and accum mode within
    FUSED_FWD_TOL, a second launch bit for bit, and its error at N=50,000,
    D=4 for R in WIDE_R (read, not checked: chip_smoke's limits come from
    these readings)."""
    import torch

    fwd = [{"family": fname, "accum": accum, "shape": shape[0],
            "rel_err": s.check_fused_matvec(fm, fam, accum, shape)[0]}
           for fname, fam in s.FAMILIES.items() for accum in ("exact", "f32x3", "fast")
           for shape in s.WIDE_SHAPES]
    errs = {}
    for R in WIDE_R:
        X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, s.ITER_D, R, seed=11)
        Xs = (X / ls).contiguous()
        v1 = v.reshape(1)
        out = fm.stationary_gram_matvec_cuda(Xs, Xs, V, v1, 0)
        ref = fm.stationary_gram_matvec_plain(Xs, Xs, V, v1, 0)
        s.check(bool(torch.isfinite(out).all()), f"wide kernel R={R}: non-finite output")
        errs[R] = float((out - ref).abs().max() / ref.abs().max())
        del X, V, Xs, out, ref
        torch.cuda.empty_cache()
    return {"fwd": fwd, "max_rel_err": max(r["rel_err"] for r in fwd),
            "fwd_tol": s.FUSED_FWD_TOL, "repeats_bit_for_bit": s.check_wide_repeat(fm),
            "rel_err_50k_by_R": errs}


def cross_checks(fm):
    """This version's B5 cross-term kernel (8 < D <= 64, R <= 16) through
    the public wrapper: chip_smoke's CROSS_SHAPES for every family within
    FUSED_FWD_TOL, and chip_smoke.check_cross."""
    fwd = [{"family": fname, "shape": shape[0],
            "rel_err": s.check_fused_matvec(fm, fam, "exact", shape)[0]}
           for fname, fam in s.FAMILIES.items() for shape in s.CROSS_SHAPES]
    return {"fwd": fwd, "max_rel_err": max(r["rel_err"] for r in fwd),
            "fwd_tol": s.FUSED_FWD_TOL, **s.check_cross(fm)}


def cross_times(versions, fm, ds, rs):
    """Each version's B5 device time per launch at N=50,000 and D > 8 (this
    version's cross-term kernel; a parent's chunk kernel), in turns, on
    inputs centred as the wrapper centres them, with its error against the
    plain twin and both bounds (chip_smoke.cross_matvec_bounds)."""
    import torch

    rows = []
    for D in ds:
        for R in rs:
            X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, D, R, seed=11)
            Xs = fm._centred(X / ls, X / ls)[0].contiguous()
            v1 = v.reshape(1)
            ref = fm.stationary_gram_matvec_plain(Xs, Xs, V, v1, 0, 0)
            scale = float(ref.abs().max())
            err = {}
            for label, fn in versions:
                out = fn(Xs, V, v1)
                torch.cuda.synchronize()
                err[label] = float((out - ref).abs().max()) / scale
            tol = s.FUSED_FWD_TOL_50K[R]
            if "this" in err:
                s.check(err["this"] <= tol, f"cross kernel D={D} R={R}: rel err {err['this']} > {tol}")
            got = {label: [] for label, _ in versions}
            for label, fn in versions + versions[::-1]:
                got[label].append(s.device_ms(lambda: fn(Xs, V, v1), reps=5, warmup=1,
                                              kernel="gram_matvec")[0])
            rows.append({"N": s.ITER_N, "D": D, "R": R, "device_ms": got,
                         "rel_err_vs_plain": err, **s.cross_matvec_bounds(s.ITER_N, s.ITER_N, D, R)})
            s.emit({"phase": "cross_times_row", **rows[-1]})
            del X, V, Xs, ref
            torch.cuda.empty_cache()
    return rows


def chunk_checks(fns, fm):
    """B6 of every version in `fns` where D > 8 or R > 16 reaches this
    version's mma kernel: at chip_smoke.MOMENT_SHAPES for every family on
    positive inputs (chip_smoke.check_fused_moments' distributions) against
    the float64 plain twin, relative to max|ref|; at N=50,000 on signed G and
    V (CHUNK_SIGNED) the same, and each version's second launch bit for bit.
    This version is held within FUSED_BWD_TOL and MOMENTS_MMA_TOL_50K; the
    others' readings are recorded."""
    import torch

    rows = []
    for N, D, R in s.MOMENT_SHAPES:
        for fname, fam in s.FAMILIES.items():
            X, _, V, ls, v = s.fused_inputs(N, None, D, R, seed=300 + D + fam + R, positive=True)
            _, _, G, _, _ = s.fused_inputs(N, None, D, R, seed=400 + D + fam + R, positive=True)
            Xs = (X / ls).contiguous()
            ref = fm.gram_moments_plain(Xs.double(), G.double(), V.double(),
                                        v.reshape(1).double(), fam)
            err = {label: float((fn(Xs, G, V, v.reshape(1), fam) - ref).abs().max()
                                / ref.abs().max()) for label, fn in fns.items()}
            s.check(err["this"] <= s.FUSED_BWD_TOL,
                    f"gram_moments {fname} N={N} D={D} R={R}: rel err {err['this']} "
                    f"> {s.FUSED_BWD_TOL}")
            rows.append({"family": fname, "N": N, "D": D, "R": R, "rel_err_vs_f64_plain": err})
    signed = []
    for D, R in CHUNK_SIGNED:
        X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, D, R, seed=12)
        _, _, G, _, _ = s.fused_inputs(s.ITER_N, None, D, R, seed=13)
        inputs = ((X / ls).contiguous(), G, V, v.reshape(1))
        err, _ = moments_errors(fns, fm, inputs)
        same = {label: bool(torch.equal(fn(*inputs), fn(*inputs))) for label, fn in fns.items()}
        tol = s.MOMENTS_MMA_TOL_50K[(D, R)]
        s.check(err["this"] <= tol and same["this"],
                f"gram_moments N={s.ITER_N} D={D} R={R} signed: rel err {err['this']} > {tol} "
                f"or two launches differ")
        signed.append({"N": s.ITER_N, "D": D, "R": R, "rel_err_vs_f64_plain": err,
                       "rel_tol": tol, "repeats_bit_for_bit": same})
        del X, V, G, inputs
        torch.cuda.empty_cache()
    return {"shapes": rows, "max_rel_err": {label: max(r["rel_err_vs_f64_plain"][label]
                                                       for r in rows) for label in fns},
            "rel_tol": s.FUSED_BWD_TOL, "signed_50k": signed}


def chunk_times(fns, names, fm, shapes):
    """Each version's B6 device time per launch at N=50,000 for (D, R) in
    `shapes`, where D > 8 or R > 16 (this version's mma kernel, a parent's
    chunk kernel; the kernel named in `names`, its reduce beside it), in
    turns, with each version's error against the float64 plain twin (read,
    not checked) and both bounds."""
    import torch

    versions = list(fns)
    rows = []
    for D, R in shapes:
        X, _, V, ls, v = s.fused_inputs(s.ITER_N, None, D, R, seed=11)
        _, _, G, _, _ = s.fused_inputs(s.ITER_N, None, D, R, seed=13)
        inputs = ((X / ls).contiguous(), G, V, v.reshape(1))
        err, _ = moments_errors(fns, fm, inputs)
        got = {label: [] for label in versions}
        reduce = {label: [] for label in versions}
        for label in versions + versions[::-1]:
            ms, reduce_ms, _, _ = s.device_ms(lambda: fns[label](*inputs), reps=5, warmup=1,
                                              kernel=names[label])
            got[label].append(ms)
            reduce[label].append(reduce_ms)
        rows.append({"N": s.ITER_N, "D": D, "R": R, "device_ms": got, "reduce_device_ms": reduce,
                     "kernel": names, "rel_err_vs_f64_plain": err,
                     **s.gram_moments_bounds(s.ITER_N, D, R)})
        s.emit({"phase": "chunk_times_row", **rows[-1]})
        del X, V, G, inputs
        torch.cuda.empty_cache()
    return rows


# run in a fresh process on a checkout (its own chip_smoke and package): the
# fused N=50,000 model's predict at 256 points, the posterior cached
PREDICT_CODE = """
import json, torch
import chip_smoke as s
X, Y, Xs = s.iterative_data()
m = s.iterative_model(X, Y, torch.float32, True)
m.log_likelihood()
m.predict(Xs)
ms = s.host_ms(lambda: m.predict(Xs), reps=2, warmup=0)
print(json.dumps({"predict_ms": ms}))
"""


# run in a fresh process on a checkout (only the package's public API, which
# a parent has too): chip_smoke.run_iterative_d12's fused model and data
# (d12_data, d12_model), its NLML+gradient at the start
OBJECTIVE_CODE = """
import json
import numpy as np, torch
import chip_smoke as s
from gpy_tpu_torch.inference import IterativeGaussianInference
from gpy_tpu_torch.kern import RBF
from gpy_tpu_torch.models import GPRegression
rng = np.random.default_rng(0)
X = rng.random((50000, 12)).astype(np.float32) * 10.0
Y = (np.sin(X[:, :1]) + 0.1 * rng.standard_normal((50000, 1))).astype(np.float32)
m = GPRegression(X, Y, RBF(12, ARD=True, lengthscale=3.0, device="cuda", dtype=torch.float32),
                 noise_var=0.1, inference_method=IterativeGaussianInference(
                     max_cg=48, n_probes=8, block=2048, materialize=False, fused=True),
                 device="cuda", dtype=torch.float32)
x = m.optimizer_array
f, _ = m._objective_and_grad(x)
ms = s.host_ms(lambda: m._objective_and_grad(x), reps=3, warmup=1)
print(json.dumps({"objective_and_grad_ms": ms, "nlml": float(f)}))
"""


def checkout_times(roots, code, key):
    """`key` of the JSON line that `code` prints, run in a fresh process on
    each checkout in `roots` (label -> directory), in turns (roots, then
    reversed); a reading per run, and each run's last line."""
    order = list(roots) + list(roots)[::-1]
    got = {label: [] for label in roots}
    last = {label: [] for label in roots}
    for label in order:
        r = subprocess.run([sys.executable, "-c", code], cwd=roots[label],
                           capture_output=True, text=True, timeout=900)
        s.check(r.returncode == 0, f"{key} on {label} failed:\n{r.stdout[-2000:]}{r.stderr[-4000:]}")
        line = json.loads(r.stdout.strip().splitlines()[-1])
        got[label].append(line[key])
        last[label].append(line)
    return {key: got, "runs": last, "order": order}


def predict_times(roots):
    """The fused model's predict ms at 256 points on each checkout in
    `roots` (label -> directory), each in a fresh process, in turns."""
    return {"N": s.ITER_N, "n_pred": s.ITER_PRED, "max_cg": s.ITER_OPTS["max_cg"],
            **checkout_times(roots, PREDICT_CODE, "predict_ms")}


def objective_times(roots):
    """The fused D=12 model's NLML+gradient ms on each checkout in `roots`,
    each in a fresh process, in turns."""
    return {"N": s.ITER_N, "D": s.D12, "max_cg": s.ITER_OPTS["max_cg"],
            "n_probes": s.ITER_OPTS["n_probes"],
            **checkout_times(roots, OBJECTIVE_CODE, "objective_and_grad_ms")}


def moments_times(fns, names, fm):
    """Each version's B6 device time per launch (the kernel named in
    `names`) and its reduce's, in turns, with its error against the float64
    plain twin, at N=50,000, D=4 for R in TIME_R."""
    import torch

    versions = list(fns)
    rows = []
    for R in TIME_R:
        inputs = moments_inputs(R)
        err, _ = moments_errors(fns, fm, inputs)
        s.check(err["this"] <= s.FUSED_BWD_TOL_50K,
                f"gram_moments R={R}: rel err {err['this']} vs float64 > {s.FUSED_BWD_TOL_50K}")
        got = {label: [] for label in versions}
        reduce = {label: [] for label in versions}
        for label in versions + versions[::-1]:
            ms, reduce_ms, _, _ = s.device_ms(lambda: fns[label](*inputs), reps=10,
                                              warmup=2, kernel=names[label])
            got[label].append(ms)
            reduce[label].append(reduce_ms)
        bound_ms, bound_by = s.gram_moments_bound(s.ITER_N, s.ITER_D, R)
        rows.append({"N": s.ITER_N, "D": s.ITER_D, "R": R, "device_ms": got,
                     "reduce_device_ms": reduce, "kernel": names,
                     "rel_err_vs_f64_plain": err, "bound_ms": bound_ms, "bound_by": bound_by})
        s.emit({"phase": "moments_times_row", **rows[-1]})
        del inputs
        torch.cuda.empty_cache()
    return rows


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="LABEL=PATH",
                    help="another gram_matvec_fused.cu")
    ap.add_argument("--phases", action="store_true",
                    help="also time PHASE_COPIES (and B6's, its mma kernel's, the wide and "
                         "the cross-term kernel's) of the checkout's source")
    ap.add_argument("--no-times", action="store_true",
                    help="build, report and check only")
    ap.add_argument("--only", choices=["wide", "cross", "chunk"],
                    help="time B5's wide kernel (with WIDE_PHASE_COPIES), its cross-term "
                         "kernel (with CROSS_PHASE_COPIES) or B6's mma kernel (with "
                         "CHUNK_PHASE_COPIES) only")
    ap.add_argument("--predict-other", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout to time the fused model's predict on")
    ap.add_argument("--objective-other", action="append", default=[], metavar="LABEL=DIR",
                    help="another checkout to time the fused D=12 model's NLML+gradient on")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("matvec_probe: torch sees no CUDA device", file=sys.stderr)
        return 1
    from gpy_tpu_torch.ops import _build
    from gpy_tpu_torch.ops import gram_matvec_fused as fm

    smi = s.nvidia_smi_line()
    s.emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
            "cuda": torch.version.cuda})
    src = os.path.join(_build.CSRC_DIR, NAME + ".cu")
    others = [o.split("=", 1) for o in args.other]
    chunk_copies = {**CHUNK_PHASE_COPIES, **CHUNK_DESIGN_COPIES}
    copies = ({**PHASE_COPIES, **MOMENTS_PHASE_COPIES, **WIDE_PHASE_COPIES, **CROSS_PHASE_COPIES,
               **chunk_copies}
              if args.phases else {"wide": WIDE_PHASE_COPIES, "cross": CROSS_PHASE_COPIES,
                                   "chunk": chunk_copies, None: {}}[args.only])
    if copies:
        others += phase_copies(src, os.path.join(_build.BUILD_DIR, "matvec_phases"), copies)
    sources = {**dict(others), "this": src}
    with ThreadPoolExecutor(max_workers=1 + len(others)) as ex:
        this = ex.submit(_build.build, NAME)
        futures = {label: ex.submit(build_other, _build, label, path, NAME)
                   for label, path in others}
        builds = {**{label: f.result() for label, f in futures.items()},
                  "this": (os.path.join(_build.BUILD_DIR, f"lib{NAME}.so"), this.result())}
    for label, (path, report) in builds.items():
        s.emit({"phase": "ptxas", "version": label, "lines": ptxas_lines(report)})
        kernels = sass(path, label, prefix="sass_matvec", keep=MAIN_PATH_SASS)
        if "error" not in kernels:
            kernels = {k: (v if any(m in k for m in MAIN_PATH_SASS)
                           else {"instructions": v["instructions"]})
                       for k, v in kernels.items()
                       if re.search(r"\dgram_(matvec_(tile_|wide_|tc_|cross_)?|moments_(tile_|mma_)?)"
                                    r"kernelI", k)}
        s.emit({"phase": "sass", "version": label, "kernels": kernels,
                "wide_tensor_core_ops": tensor_core_ops(label, s.WIDE_B5_INSTANCE),
                "cross_tensor_core_ops": tensor_core_ops(label, s.CROSS_B5_INSTANCE),
                "chunk_tensor_core_ops": tensor_core_ops(label, s.CHUNK_B6_INSTANCE)})

    fns = {label: launchers(path, label, has_diag_abi(sources[label]),
                            has_mma_moments(sources[label]))
           for label, (path, _) in builds.items()}
    b5_only = set(PHASE_COPIES) | set(WIDE_PHASE_COPIES) | set(CROSS_PHASE_COPIES)
    b6_only = set(MOMENTS_PHASE_COPIES) | set(CHUNK_PHASE_COPIES) | set(CHUNK_DESIGN_COPIES)
    b6 = {label: f[1] for label, f in fns.items() if label not in b5_only}
    s.emit({"phase": "gram_moments_check", **check_moments(b6, fm, b6_only)})
    b6_full = {label: fn for label, fn in b6.items() if label not in b6_only}
    s.emit({"phase": "chunk_checks", "nvidia_smi": smi, **chunk_checks(b6_full, fm)})
    s.emit({"phase": "wide_checks", **wide_checks(fm)})
    s.emit({"phase": "cross_checks", **cross_checks(fm)})
    if not args.no_times:
        versions = [(label, f[0]) for label, f in fns.items() if label not in b6_only]
        full = [(label, fn) for label, fn in versions if label not in b5_only]
        if args.only is None:
            s.emit({"phase": "times", "nvidia_smi": smi,
                    "rows": times([(label, fn) for label, fn in versions
                                   if label in PHASE_COPIES or label not in b5_only], fm, TIME_R)})
        if args.only in (None, "wide"):
            s.emit({"phase": "wide_times", "nvidia_smi": smi, "rows": times(full, fm, WIDE_R)})
            cuts = [(label, f[0]) for label, f in fns.items() if label in WIDE_PHASE_COPIES]
            if cuts:
                s.emit({"phase": "wide_phase_times", "nvidia_smi": smi,
                        "rows": times([("this", fns["this"][0])] + cuts, fm, (256,))})
        if args.only in (None, "cross"):
            s.emit({"phase": "cross_times", "nvidia_smi": smi,
                    "rows": cross_times(full, fm, CROSS_D, TIME_R)})
            cuts = [(label, f[0]) for label, f in fns.items() if label in CROSS_PHASE_COPIES]
            if cuts:
                s.emit({"phase": "cross_phase_times", "nvidia_smi": smi,
                        "rows": cross_times([("this", fns["this"][0])] + cuts, fm, (12,), (9,))})
        if args.only in (None, "chunk"):
            chunk_names = {label: B6_CHUNK if has_mma_moments(sources[label]) else B6_OLD_CHUNK
                           for label in b6}
            s.emit({"phase": "chunk_times", "nvidia_smi": smi,
                    "rows": chunk_times(b6_full, chunk_names, fm, CHUNK_TIMES)})
            cuts = {label: fn for label, fn in b6.items() if label in CHUNK_PHASE_COPIES}
            if cuts:
                s.emit({"phase": "chunk_phase_times", "nvidia_smi": smi,
                        "rows": chunk_times({"this": b6["this"], **cuts}, chunk_names, fm,
                                            ((12, 9),))})
            for label, shapes in CHUNK_DESIGN_TIMES.items():
                if label in b6:
                    s.emit({"phase": "chunk_design_times", "design": label, "nvidia_smi": smi,
                            "rows": chunk_times({"this": b6["this"], label: b6[label]},
                                                chunk_names, fm, shapes)})
        if args.only is None:
            names = {label: B6_TILE if "gram_moments_tile_kernel" in builds[label][1] else B6_CHUNK
                     for label in b6}
            s.emit({"phase": "moments_times", "nvidia_smi": smi,
                    "rows": moments_times(b6, names, fm)})
    here = os.path.dirname(os.path.abspath(__file__))
    if args.predict_other:
        roots = {**dict(o.split("=", 1) for o in args.predict_other), "this": here}
        s.emit({"phase": "predict_times", "nvidia_smi": smi, **predict_times(roots)})
    if args.objective_other:
        roots = {**dict(o.split("=", 1) for o in args.objective_other), "this": here}
        s.emit({"phase": "objective_times", "nvidia_smi": smi, **objective_times(roots)})
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

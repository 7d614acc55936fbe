"""matvec_probe.py's copies of the B5 and B6 source (the probe itself runs
only on the card)."""
import os

import pytest

import chip_smoke
import matvec_probe

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gpy_tpu_torch", "csrc", "gram_matvec_fused.cu")


@pytest.mark.parametrize("copies", ["PHASE_COPIES", "CROSS_PHASE_COPIES",
                                    "MOMENTS_PHASE_COPIES", "WIDE_PHASE_COPIES",
                                    "CHUNK_PHASE_COPIES", "CHUNK_DESIGN_COPIES"])
def test_phase_copies_apply_to_the_kernel_source(tmp_path, copies):
    """Each copy finds its text in csrc/gram_matvec_fused.cu exactly once
    (B5's register-tile kernel's, its cross-term kernel's (D > 8), B6's
    register-tile kernel's, B5's wide kernel's and B6's mma kernel's), so an
    edit of the kernel that moves that text fails here, not on the card."""
    table = getattr(matvec_probe, copies)
    original = open(SRC).read()
    for subs in table.values():
        for old, _ in subs:
            assert original.count(old) == 1, old
    made = matvec_probe.phase_copies(SRC, str(tmp_path), table)
    assert [label for label, _ in made] == list(table)
    for label, path in made:
        text = open(path).read()
        assert text != original
        for old, new in table[label]:
            assert old not in text or old in new
            assert new in text


def test_main_path_instance_is_the_one_launched():
    """The SASS the probe reports and the kernels line's ptxas entry name
    the instance the main path launches at D=4, R=9: RBF, R chunk 9, DMAX 4."""
    src = open(SRC).read()
    assert "if (d <= 4 && r <= 16) return matvec_tile<FAM, 4>" in src
    assert "if (r <= 9) return launch_tile<FAM, 9, DMAX>" in src
    assert chip_smoke.MAIN_B5_INSTANCE == "gram_matvec_tile_kernelILi0ELi9ELi4E"
    assert chip_smoke.MAIN_B5_INSTANCE in matvec_probe.MAIN_PATH_SASS


def test_main_path_b6_instance_is_the_one_launched():
    """The SASS the probe reports and the kernels line's ptxas entry for B6
    name the instance the main path launches at D=4, R=9 (RBF, R chunk 9,
    DMAX 4), and the profiler's name of the new kernel does not match the
    parent's chunk kernel, so the probe times each by its own name."""
    src = open(SRC).read()
    assert "if (d <= 4 && r <= 16) return moments_tile<FAM, 4>" in src
    assert "if (r <= 9) return launch_moments_tile<FAM, 9, DMAX>" in src
    assert chip_smoke.MAIN_B6_INSTANCE == "gram_moments_tile_kernelILi0ELi9ELi4E"
    assert chip_smoke.MAIN_B6_INSTANCE in matvec_probe.MAIN_PATH_SASS
    assert matvec_probe.B6_TILE.rstrip("<") in chip_smoke.MAIN_B6_INSTANCE
    assert matvec_probe.B6_CHUNK not in "gram_moments_tile_kernel<0, 9, 4>"


def _matvec_family(src):
    body = src[src.index("int matvec_family("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("d, instance", [(4, "launch_wide<FAM, 4>"), (8, "launch_wide<FAM, 8>"),
                                         (12, "launch_wide<FAM, 0>")])
def test_wide_r_routes_to_the_tensor_core_kernel(d, instance):
    """matvec_family sends R > 16 to the tensor-core kernel for D <= 8 (its
    rows' coordinates in registers: DMAX 4 or 8) and for D > 8 (DMAX 0), and
    only after every R <= 16 branch has returned; the FFMA wide kernel is
    gone, and the instance that chip_smoke.py and matvec_probe.py report
    (RBF, DMAX 4) is the kernel's template."""
    src = open(SRC).read()
    fam = _matvec_family(src)
    lines = [ln.strip() for ln in fam.splitlines() if "return" in ln]
    wide = [i for i, ln in enumerate(lines) if "launch_wide<" in ln]
    narrow = [i for i, ln in enumerate(lines) if "r <= " in ln]
    assert narrow and wide and max(narrow) < min(wide)
    cond = {4: "if (d <= 4)", 8: "if (d <= 8)", 12: "return launch_wide<FAM, 0>"}[d]
    line = next(ln for ln in lines if instance in ln)
    assert line.startswith(cond)
    assert "gram_matvec_wide_kernel" not in src
    assert "launch_wide<FAM, DMAX>" not in fam
    assert "gram_matvec_tc_kernel<FAM, DMAX><<<" in src
    assert chip_smoke.WIDE_B5_INSTANCE == "gram_matvec_tc_kernelILi0ELi4E"
    assert chip_smoke.WIDE_B5_INSTANCE in matvec_probe.MAIN_PATH_SASS
    assert "template <int FAM, int DMAX>\n__global__ void __launch_bounds__(kWideThreads, 1)\n" \
           "gram_matvec_tc_kernel(" in src


def test_wide_producers_wait_for_tile_0s_raw_rows():
    """The tensor-core kernel's producers copy tile j + 2's V rows into the
    raw buffer tile j - 1 was read from (three buffers), so from tile 1 on
    they wait on EMPTY before that copy; at tile 1 the consumers' arrival
    comes after their transpose of tile 0, before their walk."""
    src = open(SRC).read()
    produce = src[src.index("void wide_produce("):src.index("gram_matvec_tc_kernel(")]
    assert "constexpr int kRawBufs = 3;" in src
    assert "if (tile >= 1) bar_sync(kBarEmpty + buf, kWideThreads);" in produce
    assert produce.index("bar_sync(kBarEmpty + buf") < produce.index("fetch(tile + 2);")
    consume = src[src.index("gram_matvec_tc_kernel("):src.index("int launch_wide(")]
    pre = consume[consume.index("if (tiles > 0) {"):consume.index("for (int64_t tile = 0;")]
    assert pre.index("transpose(0);") < pre.index(
        "if (tiles > 1) bar_arrive(kBarEmpty + 1, kWideThreads);")


@pytest.mark.parametrize("d, r, route", [(9, 1, "cross"), (12, 9, "cross"), (64, 16, "cross"),
                                         (65, 9, "wide"), (12, 17, "wide")])
def test_wide_d_narrow_r_routes_to_the_cross_term_kernel(d, r, route):
    """matvec_family sends 8 < D <= kCrossMaxD (64) at R <= 16 to the
    cross-term kernel, after the register-tile kernel's branches and before
    the tensor-core kernel's, which takes R > 16 and D > 64; the chunk kernel
    it replaced is gone; matvec_cross picks R chunk 1, 9 or 16; its launch
    takes two m-blocks a warp where three blocks fit in shared memory, else
    one; and the instance chip_smoke.py and matvec_probe.py report (RBF, R
    chunk 9, two m-blocks: the D=12 path's) is the kernel's template."""
    src = open(SRC).read()
    fam = _matvec_family(src)
    lines = [ln.strip() for ln in fam.splitlines() if "return" in ln]
    cross = next(i for i, ln in enumerate(lines) if "matvec_cross<FAM>" in ln)
    tile = [i for i, ln in enumerate(lines) if "matvec_tile<" in ln]
    wide = [i for i, ln in enumerate(lines) if "launch_wide<" in ln]
    assert max(tile) < cross < min(wide)
    assert lines[cross].startswith("if (d <= kCrossMaxD && r <= 16)")
    assert "constexpr int kCrossMaxD = 64;" in src
    taken = "cross" if 8 < d <= 64 and r <= 16 else "wide"
    assert taken == route
    body = src[src.index("int matvec_cross("):]
    body = body[:body.index("\n}\n")]
    assert "if (r == 1) return launch_cross<FAM, 1>" in body
    assert "if (r <= 9) return launch_cross<FAM, 9>" in body
    assert "return launch_cross<FAM, 16>" in body
    assert "gram_matvec_kernel<" not in src and "launch_matvec" not in src
    assert "template <int FAM, int RC, int MB>\n__global__ void __launch_bounds__(" \
           "kCrossThreads<MB>, cross_min_blocks(RC, MB))\ngram_matvec_cross_kernel(" in src
    assert chip_smoke.CROSS_B5_INSTANCE == "gram_matvec_cross_kernelILi0ELi9ELi2EE"
    assert chip_smoke.CROSS_B5_INSTANCE in matvec_probe.MAIN_PATH_SASS
    assert chip_smoke.CROSS_MAX_D == 64
    launch = src[src.index("int launch_cross("):src.index("int matvec_cross(")]
    assert "const bool two = cross_min_blocks(RC, 2) * (bytes + 1024) <= 228 * 1024;" in launch
    assert "if (two)\n    gram_matvec_cross_kernel<FAM, RC, 2><<<" in launch


def test_probe_calls_each_version_with_its_own_c_interface(tmp_path):
    """B5's entry point takes the diagonal's row offset, the wrapper passes
    it, and the probe calls a version without it (a parent's) without it."""
    src = open(SRC).read()
    assert matvec_probe.has_diag_abi(SRC)
    old = tmp_path / "old.cu"
    old.write_text(src.replace("int r, int family, int64_t diag, void* stream",
                               "int r, int family, void* stream"))
    assert not matvec_probe.has_diag_abi(str(old))


def _moments_family(src):
    body = src[src.index("int moments_family("):]
    return body[:body.index("\n}\n")]


@pytest.mark.parametrize("d, r, route", [(4, 9, "tile<FAM, 4>"), (8, 16, "tile<FAM, 8>"),
                                         (4, 17, "mma<FAM, 4, 0>"), (8, 64, "mma<FAM, 8, 0>"),
                                         (9, 1, "mma<FAM, 12>"), (12, 9, "mma<FAM, 12>"),
                                         (13, 9, "mma<FAM, 0>"), (127, 1, "mma<FAM, 0>")])
def test_chunk_domain_routes_to_the_mma_kernel(d, r, route):
    """moments_family sends D > 8 or R > 16 to the mma kernel (DMAX 4, 8 and
    12 in registers, 0: two passes above D = 12), after the register-tile
    kernel's two branches; moments_mma fixes its k-steps at 1 and 2 for R
    <= 8 and <= 16; the chunk kernel it replaced and its launch are gone;
    the instance chip_smoke.py and matvec_probe.py name for the D=12 path
    (RBF, DMAX 12, two k-steps) and the profiler name the launch checks
    read are the new kernel's."""
    src = open(SRC).read()
    lines = [ln.strip() for ln in _moments_family(src).splitlines() if "return" in ln]
    conds = [("d <= 4 && r <= 16", "tile<FAM, 4>"), ("d <= 8 && r <= 16", "tile<FAM, 8>"),
             ("d <= 4)", "mma<FAM, 4, 0>"), ("d <= 8)", "mma<FAM, 8, 0>"),
             ("d <= 12)", "mma<FAM, 12>"), ("", "mma<FAM, 0>")]
    assert len(lines) == len(conds)
    for ln, (cond, target) in zip(lines, conds):
        assert cond in ln and target in ln
    taken = next(t for c, t in [(d <= 4 and r <= 16, "tile<FAM, 4>"),
                                (d <= 8 and r <= 16, "tile<FAM, 8>"), (d <= 4, "mma<FAM, 4, 0>"),
                                (d <= 8, "mma<FAM, 8, 0>"), (d <= 12, "mma<FAM, 12>"),
                                (True, "mma<FAM, 0>")] if c)
    assert taken == route
    body = src[src.index("int moments_mma("):]
    body = body[:body.index("\n}\n")]
    assert "if (r <= 8) return launch_moments_mma<FAM, DMAX, 1>" in body
    assert "if (r <= 16) return launch_moments_mma<FAM, DMAX, 2>" in body
    assert "return launch_moments_mma<FAM, DMAX, 0>" in body
    assert "gram_moments_kernel<" not in src and "gram_moments_kernel(" not in src
    assert "template <int FAM, int DMAX, int KS>\n__global__ void __launch_bounds__(kBlock, " \
           "mom_min_blocks(DMAX))\ngram_moments_mma_kernel(" in src
    assert chip_smoke.B6_CHUNK_KERNEL == "gram_moments_mma_kernel<"
    assert chip_smoke.CHUNK_B6_INSTANCE == "gram_moments_mma_kernelILi0ELi12ELi2EE"
    assert chip_smoke.CHUNK_B6_INSTANCE in matvec_probe.MAIN_PATH_SASS
    assert matvec_probe.has_mma_moments(SRC)

"""matvec_probe.py's copies of the B5 and B6 source (the probe itself runs
only on the card)."""
import os

import pytest

import chip_smoke
import matvec_probe

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "gpy_tpu_torch", "csrc", "gram_matvec_fused.cu")


@pytest.mark.parametrize("copies", ["PHASE_COPIES", "CHUNK_PHASE_COPIES",
                                    "MOMENTS_PHASE_COPIES"])
def test_phase_copies_apply_to_the_kernel_source(tmp_path, copies):
    """Each copy finds its text in csrc/gram_matvec_fused.cu exactly once
    (B5's register-tile kernel's, the chunk kernel's that the D > 8 path
    keeps, and B6's register-tile kernel's), so an edit of the kernel that
    moves that text fails here, not on the card."""
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

"""chol_probe.py's SASS reader, on a listing in cuobjdump's format, and its
timing-only copies of the kernel source (the probe itself runs only on the
card)."""
import os

import chol_probe

LISTING = """
	code for sm_90a
		Function : _Z3fooPf
	.headerflags	@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                /* 0x00000a00ff017b82 */
        /*0010*/                   S2R R0, SR_TID.X ;                    /* 0x0000000000007919 */
        /*0020*/                   LDS R2, [R0] ;                        /* 0x0000000000027984 */
        /*0030*/                   FFMA R3, R2, R2, R3 ;                 /* 0x0000000202037223 */
        /*0040*/                   ISETP.GE.AND P0, PT, R0, 0x80, PT ;   /* 0x000000800000780c */
        /*0050*/              @!P0 BRA 0x20 ;                            /* 0xfffffffc0000a947 */
        /*0060*/               @P0 BRA 0x80 ;                            /* 0x0000000000000947 */
        /*0070*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;         /* 0x0000000000007b1d */
        /*0080*/                   EXIT ;                                /* 0x000000000000794d */
		Function : _Z3barPf
        /*0000*/                   EXIT ;                                /* 0x000000000000794d */
"""


def test_parse_sass_counts_instructions_and_loops():
    got = chol_probe.parse_sass(LISTING)
    assert set(got) == {"_Z3fooPf", "_Z3barPf"}
    foo = got["_Z3fooPf"]
    assert foo["instructions"] == 9
    assert foo["by_opcode"]["BRA"] == 2 and foo["by_opcode"]["BAR"] == 1
    # one backward branch (0x50 -> 0x20): LDS, FFMA, ISETP, BRA; the forward one is no loop
    assert foo["loops"] == [{"head": "0x20", "branch": "0x50", "instructions": 4,
                             "by_opcode": {"LDS": 1, "FFMA": 1, "ISETP": 1, "BRA": 1}}]
    assert got["_Z3barPf"] == {"instructions": 1, "by_opcode": {"EXIT": 1}, "loops": []}


def test_phase_copies_apply_to_the_kernel_source(tmp_path):
    """Each timing-only copy finds its text in csrc/block_chol.cu exactly
    once, so an edit of the kernel that moves that text fails here, not on
    the card."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "gpy_tpu_torch", "csrc", "block_chol.cu")
    copies = chol_probe.phase_copies(src, str(tmp_path))
    assert [label for label, _ in copies] == list(chol_probe.PHASE_COPIES)
    original = open(src).read()
    for label, path in copies:
        text = open(path).read()
        assert text != original
        for old, new in chol_probe.PHASE_COPIES[label]:
            assert old not in text or old in new
            assert new in text

"""Shared constants of the PyTorch port (same values as bsalign_tpu.constants).

Semantics mirror the reference bsalign (bsalign.h:30-69).
"""

# Alignment modes (bsalign.h:30-38)
MODE_GLOBAL = 0
MODE_OVERLAP = 1
MODE_EXTEND = 2
MODE_KMER = 3
MODEMASK_TYPE = 0x3


def mode_type(mode: int) -> int:
    return mode & MODEMASK_TYPE


MODE_NAMES = {
    "global": MODE_GLOBAL,
    "overlap": MODE_OVERLAP,
    "extend": MODE_EXTEND,
    "kmer": MODE_KMER,
}


def parse_mode_list(s, allowed=("global", "overlap", "extend")):
    """The reference CLIs' -m parsing (main.c:140-153 and twins): a
    comma-separated list where each token is matched case-insensitively,
    the LAST valid token wins, a trailing comma is ignored, and any
    unknown (or empty non-final) token is a usage error. Returns the
    winning mode name, or None on a usage error."""
    toks = s.split(",")
    if len(toks) > 1 and toks[-1] == "":
        toks = toks[:-1]
    mode = None
    for tok in toks:
        key = tok.lower()
        if key not in allowed:
            return None
        mode = key
    return mode


# Score ranges (bsalign.h:56-59)
SCORE_EPI8_MIN = -(0x7F >> 1)  # -63
SCORE_EPI8_MAX = 0x7F >> 1  # 63
SCORE_MIN = -(0x7FFFFFFF >> 2)

# packed CIGAR ops (bsalign.h:401-417): M I D N S H P = X
CIGAR_CHARS = "MIDNSHP=X*"

# The reference's striped-SIMD geometry (SSE build: 16 int8 lanes).
# Band layout, per-stripe score anchors and the adaptive-band heuristics all
# depend on this constant; we pin it to the reference's default build so that
# scores/CIGARs are reproduced exactly (bsalign.h:74/136: WORDSIZE 32/16).
WORDSIZE = 16


def roundup(v: int, base: int) -> int:
    return (v + base - 1) // base * base

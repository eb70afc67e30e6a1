"""Global constants for thermite-tpu.

Scoring follows the reference aligner's fixed unit scoring
(`Scoring::from_scores(-1, -1, 1, -1)`, reference src/aligner.rs:140):
match = +1, mismatch = -1, gap open = -1, gap extend = -1.

The sentinel score ``MIN_SCORE`` mirrors rust-bio's ``MIN_SCORE``
(-2^30, far enough from 0 that adding per-cell penalties cannot
underflow an int32).
"""

MATCH_SCORE = 1
MISMATCH_SCORE = -1
GAP_OPEN = -1
GAP_EXTEND = -1

MIN_SCORE = -(1 << 30)

# Sequence byte codes.  We keep raw uppercase ASCII bytes for sequence
# storage so equality semantics match the reference exactly (the
# reference compares raw bytes: 'N' == 'N' scores as a match,
# reference src/swg.rs:92).  '$' separates chromosomes in the
# concatenated text (reference src/index.rs:76) and never equals a
# read base.
SENTINEL = ord("$")

# Base-5 packing alphabet for k-mer seed tables: A,C,G,T,N.
# Using base 5 (not 4) keeps N-containing k-mers exactly searchable,
# matching the reference's FM-index alphabet "ACGNT"
# (reference src/index.rs:108).
BASE5 = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3, ord("N"): 4}

# Default CLI parameters (reference src/main.rs:98-132).
DEFAULT_MIN_SEED_LEN = 20
DEFAULT_MIN_ALN_SCORE_PERCENT = 0.66
DEFAULT_MIN_ALN_SCORE = 30
DEFAULT_MULTIMAP_SCORE_RANGE = 1

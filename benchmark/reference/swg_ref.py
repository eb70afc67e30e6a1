"""Scalar oracle for banded Smith-Waterman-Gotoh *extension* alignment.

Semantics re-derived from the reference kernel (reference src/swg.rs:31-240):
anchored at (0, 0), free end chosen at the global maximum cell, banded
with band width ``b`` (2b+1 cells per column), affine gaps, X-drop early
termination.  This module is the slow-but-exact referee used to
validate the batched CUDA kernels; it is NOT the production path.

Notable behaviours replicated faithfully:

* Column 0 is initialised with a gap ladder (R-only) and an 'Ins' trace
  row (reference src/swg.rs:61-71).
* Columns 1..=b anchor the band at row 0 ("phase 1"); later columns
  slide it down one row per column ("phase 2") (src/swg.rs:75-154).
* Direction tie-break priority is diagonal > deletion > insertion
  (src/swg.rs:226-240).
* The global max updates only on strictly-greater scores, so the
  earliest (column, then row) max cell wins ties (src/swg.rs:101-104).
* An X-drop break in phase 1 terminates the whole extension.  (The
  reference's `break` only exits the phase-1 loop and would resume
  phase 2 from stale state, src/swg.rs:110-113 — but any phase-2 trace
  write after that indexes out of bounds because the trace vec grows
  one row per column, src/swg.rs:210-216; the resume path is de-facto
  unreachable/UB, so we define the clean global-stop semantic.)
* The query suffix past the max cell is soft-clipped (src/swg.rs:179).
"""

from __future__ import annotations

from typing import List, Tuple

from .constants import GAP_EXTEND, GAP_OPEN, MATCH_SCORE, MIN_SCORE, MISMATCH_SCORE
from .types import Alignment, Op, OP_DEL, OP_INS, OP_MATCH, OP_SUBST, xclip

_DIR_OPS = (OP_MATCH, OP_SUBST, OP_DEL, OP_INS)


def _triple_max(d: int, c: int, r: int, is_match: bool) -> Tuple[int, str]:
    score = max(d, c, r)
    if score == d:
        op = OP_MATCH if is_match else OP_SUBST
    elif score == c:
        op = OP_DEL
    else:
        op = OP_INS
    return score, op


class SwgExtend:
    """Reusable banded SWG extension aligner (oracle implementation)."""

    def __init__(self, max_band_width: int):
        self.max_band_width = max_band_width
        w = 2 * max_band_width + 1
        self.D = [0] * w
        self.C = [0] * w
        self.R = [0] * w
        # trace[j] is a list of w ops for column j; default fill 'M'
        # mirrors the reference's resize default.
        self.trace: List[List[str]] = []

    def _set_trace(self, j: int, i: int, op: str) -> None:
        w = 2 * self.max_band_width + 1
        while len(self.trace) <= j:
            self.trace.append([OP_MATCH] * w)
        self.trace[j][i] = op

    def _get_trace(self, j: int, i: int) -> str:
        return self.trace[j][i]

    def extend(self, x: bytes, y: bytes, band_width: int, x_drop: int) -> Alignment:
        assert band_width <= self.max_band_width, (
            f"Band width of {band_width} must be less than the max band "
            f"width of {self.max_band_width}!"
        )

        if len(x) == 0 or len(y) == 0:
            ops: List[Op] = [xclip(len(x))] if len(x) > 0 else []
            return Alignment(
                score=0, ystart=0, xstart=0, yend=0, xend=0,
                ylen=len(y), xlen=len(x), operations=ops,
            )

        w = band_width * 2 + 1
        D, C, R = self.D, self.C, self.R
        max_score = 0
        max_i, max_j = 0, 0

        # column 0: gap ladder
        D[0] = C[0] = R[0] = 0
        self._set_trace(0, 0, OP_INS)
        for i in range(1, w):
            C[i] = MIN_SCORE
            R[i] = i * GAP_EXTEND + GAP_OPEN
            D[i] = R[i]
            self._set_trace(0, i, OP_INS)

        # phase 1: band anchored at row 0
        for j in range(1, min(band_width, len(y)) + 1):
            band_max = MIN_SCORE
            prev_D = MIN_SCORE
            for i in range(min(w, len(x) + 1)):
                C[i] = max(C[i] + GAP_EXTEND, D[i] + GAP_EXTEND + GAP_OPEN)
                if i == 0:
                    R[i] = MIN_SCORE
                else:
                    R[i] = max(R[i - 1] + GAP_EXTEND, D[i - 1] + GAP_EXTEND + GAP_OPEN)
                if i == 0:
                    d = MIN_SCORE
                else:
                    s = MATCH_SCORE if x[i - 1] == y[j - 1] else MISMATCH_SCORE
                    d = prev_D + s
                prev_D = D[i]

                curr_D, op = _triple_max(d, C[i], R[i], i > 0 and x[i - 1] == y[j - 1])
                D[i] = curr_D
                self._set_trace(j, i, op)

                if D[i] > max_score:
                    max_score = D[i]
                    max_i, max_j = i, j
                band_max = max(band_max, D[i])

            if band_max < max_score - x_drop:
                # The reference `break` here only exits the phase-1 loop
                # and lets phase 2 run from stale state
                # (src/swg.rs:110-113) — but any phase-2 trace write then
                # indexes out of bounds in the reference (its trace vec
                # grows one row per column, src/swg.rs:210-216), i.e. the
                # resume path is de-facto unreachable/UB.  We define the
                # clean semantic: X-drop terminates the whole extension.
                return Alignment(
                    score=max_score,
                    ystart=0,
                    xstart=0,
                    yend=max_j,
                    xend=max_i,
                    ylen=len(y),
                    xlen=len(x),
                    operations=self._traceback(max_i, max_j, len(x), band_width),
                )

        # phase 2: band slides down one row per column
        for j in range(band_width + 1, len(y) + 1):
            band_max = MIN_SCORE
            for i in range(j - band_width, min(j - band_width + w, len(x) + 1)):
                bi = i - (j - band_width)

                if bi >= w - 1:
                    C[bi] = MIN_SCORE
                else:
                    C[bi] = max(
                        C[bi + 1] + GAP_EXTEND, D[bi + 1] + GAP_EXTEND + GAP_OPEN
                    )
                if bi == 0:
                    R[bi] = MIN_SCORE
                else:
                    R[bi] = max(
                        R[bi - 1] + GAP_EXTEND, D[bi - 1] + GAP_EXTEND + GAP_OPEN
                    )
                is_match = x[i - 1] == y[j - 1]
                s = MATCH_SCORE if is_match else MISMATCH_SCORE
                d = D[bi] + s

                curr_D, op = _triple_max(d, C[bi], R[bi], is_match)
                D[bi] = curr_D
                self._set_trace(j, bi, op)

                if D[bi] > max_score:
                    max_score = D[bi]
                    max_i, max_j = i, j
                band_max = max(band_max, D[bi])

            if band_max < max_score - x_drop:
                break

        return Alignment(
            score=max_score,
            ystart=0,
            xstart=0,
            yend=max_j,
            xend=max_i,
            ylen=len(y),
            xlen=len(x),
            operations=self._traceback(max_i, max_j, len(x), band_width),
        )

    def _traceback(self, i: int, j: int, xlen: int, band_width: int) -> List[Op]:
        ops: List[Op] = []
        if i < xlen:
            ops.append(xclip(xlen - i))
        while i > 0 or j > 0:
            # Clamp to the band: only reachable in the reference's
            # de-facto-unreachable phase-1-break regime, where the Rust
            # code would index out of bounds (src/swg.rs:183-186 after a
            # src/swg.rs:110 break).  Clamping defines those walks
            # consistently across the oracle and the batched kernel.
            bi = min(max(i - max(0, j - band_width), 0), 2 * band_width)
            op = self._get_trace(j, bi)
            ops.append(op)
            if op == OP_MATCH or op == OP_SUBST:
                i -= 1
                j -= 1
            elif op == OP_INS:
                i -= 1
            elif op == OP_DEL:
                j -= 1
            else:  # pragma: no cover
                raise AssertionError("invalid trace op")
        ops.reverse()
        return ops

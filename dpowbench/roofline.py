"""The search's roofline: the least integer work one hash needs, and the
card's peak rate for it.

Work per hash, a lower bound that holds for any implementation
--------------------------------------------------------------

One hash is Blake2b with an 8-byte digest over the 40-byte message
``nonce_le || block_hash``: one compression of 12 rounds, each of 8 G
functions on 64-bit words. The H100 has no 64-bit integer ALU: a word is two
32-bit halves. Per G,

    a += b + m[x];  d = rotr64(d ^ a, 32);  c += d;  b = rotr64(b ^ c, 24)
    a += b + m[y];  d = rotr64(d ^ a, 16);  c += d;  b = rotr64(b ^ c, 63)

An SM issues 32-bit integer work on two pipes, 64 lanes a clock each
(compute capability 9.0): the ALU pipe (LOP3, PRMT, SHF, IADD3, ...) and the
FMA pipe (IMAD and its forms). Counted, per half of a word, as the fewest
32-bit instructions on either pipe:

  * XOR: one LOP3, which only the ALU pipe issues (a 3-input LOP3 cannot
    fuse two XORs of a G: each result feeds a rotate or an add before the
    next). 4 per G, so 8 instructions;
  * rotate: rotr 32 swaps the halves, 0 instructions; rotr 24, rotr 16 and
    rotr 63 take one PRMT or SHF per half on the ALU pipe, or two on the FMA
    pipe (IMAD.HI and IMAD, or IDP and IMAD for a byte rotation), so at
    least 1. 6 per G. The count is a floor: IMAD.HI issues at half rate on
    the H100 and slows the ALU work beside it, so no kernel reaches the mix
    that puts every rotate on the FMA pipe;
  * add: a 64-bit add of two or three words is one IADD3 or IMAD per half
    with the carry: 4 per G, 8 instructions. Fusing a rotate into the add
    that reads it leaves the rotated word to compute all the same, since the
    next XOR reads it too.

So a whole G is 8 XOR + 6 rotate + 8 add = 22 instructions.

What a kernel may leave out, and this count leaves out too:

  * Round 0 mixes the columns first: G1, G2 and G3 read message words 2-7
    (the block hash and zeros), the chaining state and the counter, never
    the nonce (word 0, read only by G0). They are the same for every nonce
    of a row and can be computed once per row: 3 G.
  * Only the first output word is needed, ``h0 ^ v0 ^ v8``. In round 11's
    diagonal step, G5 and G7 write neither v0 nor v8: 2 G. G4 is needed
    only up to its second add, which gives v0: its last two XORs and last
    two rotates go (4 XOR, 4 rotate, 2 add saved). G6 is needed only up to
    its last ``c += d``, which gives v8: its last XOR and rotr 63 go (2 XOR,
    2 rotate saved).
  * In round 11's column step, G0 and G2 feed the diagonal only through a
    and c (v0, v8 and v2, v10), so their last XOR and rotr 63 go: 2 XOR and
    2 rotate saved each. G1 and G3 end in the b and d that G4 and G6 read.
  * The final ``h0 ^ v0 ^ v8`` is one 3-input LOP3 per half: 2 XOR more.
    The threshold compare is not counted.

  XOR     96 x 8 - 5 x 8 - 4 - 2 - 4 + 2 = 720   (ALU pipe only)
  rotate  96 x 6 - 5 x 6 - 4 - 2 - 4     = 536
  add     96 x 8 - 5 x 8 - 2             = 726

The least time for a hash is the larger of the XORs over the ALU pipe alone
and all 1,982 instructions over both pipes together: 720 / 64 = 11.25 and
1,982 / 128 = 15.48 lane-clocks, so both pipes, full and evenly loaded, set
the bound. A kernel with more work on one pipe takes longer, so no kernel
reads over 100 %. A test prices the search kernel's SASS by the same peaks
(1,324 ALU- and 1,028 FMA-pipe instructions per nonce today, with rotr 24
and rotr 16 as IDP and IMAD; 1,687 and 304 before): it reads under 100 %.

Peak: the SMs' lanes of both pipes at the card's maximum SM clock as
``nvidia-smi`` reads it.
"""

from __future__ import annotations

import subprocess
from typing import Optional

#: 32-bit instructions one hash needs at least (derivation above): XORs,
#: which only the ALU pipe issues, and rotates and adds, which either may
XOR_OPS_PER_HASH = 720
ROTATE_OPS_PER_HASH = 536
ADD_OPS_PER_HASH = 726
INT_OPS_PER_HASH = XOR_OPS_PER_HASH + ROTATE_OPS_PER_HASH + ADD_OPS_PER_HASH
#: SMs, and each SM's integer lanes per clock on each pipe, by the card's name
PEAKS = {"NVIDIA H100 80GB HBM3": {"sms": 132, "alu_lanes_per_sm": 64, "fma_lanes_per_sm": 64}}


def card_clocks() -> Optional[dict]:
    """The card's maximum SM clock (MHz) and power limit (W) from
    ``nvidia-smi``, or None where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm,power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        mhz, watts = (float(x) for x in out.splitlines()[0].split(","))
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    return {"max_sm_clock_mhz": mhz, "power_limit_w": watts}


def bound_seconds(hashes: float, kind: str, max_sm_clock_mhz: float) -> Optional[float]:
    """The least time the card needs for ``hashes`` hashes: the larger of the
    XORs on the ALU pipe alone and all the work on both pipes."""
    card = PEAKS.get(kind)
    if card is None:
        return None
    clocks_per_s = card["sms"] * max_sm_clock_mhz * 1e6
    per_hash = max(XOR_OPS_PER_HASH / card["alu_lanes_per_sm"],
                   INT_OPS_PER_HASH / (card["alu_lanes_per_sm"] + card["fma_lanes_per_sm"]))
    return hashes * per_hash / clocks_per_s


def share_pct(hashes: float, kernel_seconds: float, kind: str,
              max_sm_clock_mhz: float) -> Optional[float]:
    """Percent of the card's roofline that ``hashes`` in ``kernel_seconds``
    of the search kernel reach; None where there is nothing to price."""
    if hashes <= 0 or kernel_seconds <= 0:
        return None
    bound = bound_seconds(hashes, kind, max_sm_clock_mhz)
    return None if bound is None else 100.0 * bound / kernel_seconds

"""Bit-packed flood fill: 32 X-cells per int32 word (counterpart of
``openimpala_tpu/ops/packfill.py``, whose layout it keeps bit for bit: bit
b of word w is cell x = 32 w + b, and X is padded with closed cells).

Each directional sweep is integer bit arithmetic on whole word volumes:

* X sweeps: a Kogge-Stone occluded fill inside each word (five shift /
  and / or steps resolve all 32 bits), a carry-lookahead (propagate,
  generate) scan across the X/32 word planes, then a carry-run fill;
* Y and Z sweeps: the recurrence ``s[y] = open[y] & (reach[y] | s[y-1])``
  as a log-doubling scan of the transfers ``s' = (a & s) | b``, 32 lines
  per word op.

A round is the six sweeps back to back; rounds repeat until the reach
stops changing, the fixed point of BFS reachability.  Plain PyTorch tensor
code: on a CUDA tensor every op runs on the card and the only host read is
the fixed-point test, once per round.

The words are held in ``torch.int32`` (``torch.uint32`` has no shifts),
so: every right shift is masked (``_srl``; ``>>`` on int32 is arithmetic),
the top bit is tested as ``word < 0``, the full word is ``-1`` and bit 31
is ``-2**31``; ``_low_run``'s ``o + 1`` wraps from ``2**31 - 1`` to
``-2**31`` as the unsigned add does.
"""

from __future__ import annotations

import torch

from ..utils import profiling

_FULL = -1  # 0xFFFFFFFF as int32
_TOP = -(2 ** 31)  # 0x80000000 as int32


def _bit(b: int) -> int:
    """Bit ``b`` of a word as an int32 value."""
    return _TOP if b == 31 else 1 << b


def pack_x(mask: torch.Tensor) -> torch.Tensor:
    """bool (X, Y, Z) -> int32 (ceil(X/32), Y, Z); bit b of word w is cell
    x = 32 w + b.  X is padded with closed cells (zero bits)."""
    X, Y, Z = mask.shape
    xw = -(-X // 32)
    m = mask.to(torch.bool)
    if xw * 32 != X:
        m = torch.cat([m, m.new_zeros((xw * 32 - X, Y, Z))])
    m = m.reshape(xw, 32, Y, Z)
    words = m[:, 0].to(torch.int32)
    for b in range(1, 32):
        words |= m[:, b].to(torch.int32) << b
    return words


def unpack_x(words: torch.Tensor, X: int) -> torch.Tensor:
    """int32 (Xw, Y, Z) -> bool (X, Y, Z) (the padded X cells cropped)."""
    xw, Y, Z = words.shape
    bits = torch.arange(32, dtype=torch.int32, device=words.device)
    cells = (words[:, None] >> bits.reshape(1, 32, 1, 1)) & 1
    return cells.reshape(xw * 32, Y, Z)[:X].to(torch.bool)


def _srl(x, k: int):
    """Logical right shift of int32 words by ``k`` (1 <= k <= 31)."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _lo_hi(n: int, k: int, reverse: bool):
    """(destination, source) index ranges of a shift by ``k``: element i
    takes the value from i - k (forward) or i + k (``reverse``)."""
    if not reverse:
        return (k, n - k), (0, n - k)
    return (0, n - k), (k, n - k)


def _shift(x, k: int, axis: int, reverse: bool):
    """Zero-filled shift along ``axis``: element i takes the value from
    i - k (forward) or i + k (``reverse``)."""
    n = x.shape[axis]
    out = torch.zeros_like(x)
    if k < n:
        (d0, dn), (s0, sn) = _lo_hi(n, k, reverse)
        out.narrow(axis, d0, dn).copy_(x.narrow(axis, s0, sn))
    return out


def _keep(n: int, k: int, reverse: bool) -> int:
    """Start of the ``k`` elements a shift by ``k`` does not reach."""
    return 0 if not reverse else n - k


def _or_and_shift(b, a, k: int, axis: int, reverse: bool):
    """``b | (a & _shift(b, k))`` without materialising the shifted copy."""
    n = b.shape[axis]
    out = torch.empty_like(b)
    (d0, dn), (s0, sn) = _lo_hi(n, k, reverse)
    keep = _keep(n, k, reverse)
    out.narrow(axis, keep, k).copy_(b.narrow(axis, keep, k))
    dst = out.narrow(axis, d0, dn)
    torch.bitwise_and(a.narrow(axis, d0, dn), b.narrow(axis, s0, sn),
                      out=dst)
    dst.bitwise_or_(b.narrow(axis, d0, dn))
    return out


def _and_shift(a, k: int, axis: int, reverse: bool):
    """``a & _shift(a, k)`` (zero where the shift brings zeros in)."""
    n = a.shape[axis]
    out = torch.empty_like(a)
    (d0, dn), (s0, sn) = _lo_hi(n, k, reverse)
    out.narrow(axis, _keep(n, k, reverse), k).zero_()
    torch.bitwise_and(a.narrow(axis, d0, dn), a.narrow(axis, s0, sn),
                      out=out.narrow(axis, d0, dn))
    return out


def _scan_semiring(o, r, axis: int, reverse: bool):
    """Inclusive scan of ``s[i] = o[i] & (r[i] | s[i-1])`` along ``axis`` by
    operator doubling: b holds the resolved reach, a the open-path
    indicator for the current span length (its last doubling, which no
    later step reads, is skipped)."""
    a, b = o, r
    n = o.shape[axis]
    k = 1
    while k < n:
        b = _or_and_shift(b, a, k, axis, reverse)
        if 2 * k < n:
            a = _and_shift(a, k, axis, reverse)
        k *= 2
    return b


def _ks_fill_up(o, g):
    """Kogge-Stone occluded fill toward the top bit: every open bit with a
    seed below it in the same word through contiguous open bits."""
    g = g | (o & (g << 1))
    p = o & (o << 1)
    g = g | (p & (g << 2))
    p = p & (p << 2)
    g = g | (p & (g << 4))
    p = p & (p << 4)
    g = g | (p & (g << 8))
    p = p & (p << 8)
    return g | (p & (g << 16))


def _ks_fill_down(o, g):
    g = g | (o & _srl(g, 1))
    p = o & _srl(o, 1)
    g = g | (p & _srl(g, 2))
    p = p & _srl(p, 2)
    g = g | (p & _srl(g, 4))
    p = p & _srl(p, 4)
    g = g | (p & _srl(g, 8))
    p = p & _srl(p, 8)
    return g | (p & _srl(g, 16))


def _low_run(o):
    """Bits of the contiguous open run starting at bit 0 (empty if bit 0 is
    closed): the cells a carry-in at the word's low edge floods."""
    return o & ~(o + 1)


def _high_run(o):
    """Bits of the contiguous open run ending at bit 31: the down-smear of
    the top bit through open cells."""
    return _ks_fill_down(o, o & _TOP)


def _default_carry_in(prop, gen, reverse: bool):
    """Exclusive carry per word plane: the word-level (propagate, generate)
    recurrence ``c_out = gen | (prop & c_in)`` resolved along axis 0."""
    c_out = _scan_semiring(prop, gen, 0, reverse)
    return _shift(c_out, 1, 0, reverse)


def _sweep_x(o, r, reverse: bool, carry_in_fn=_default_carry_in):
    """One directional X sweep on the packed words: intra-word Kogge-Stone
    fill, carry-lookahead across word planes, carry-run fill.
    ``carry_in_fn`` resolves the word-level carry recurrence (the sharded
    fill's crosses ranks)."""
    if not reverse:
        g = _ks_fill_up(o, r)
        gen = g < 0  # the fill reached the word's top bit
    else:
        g = _ks_fill_down(o, r)
        gen = (g & 1).to(torch.bool)
    prop = o == _FULL  # a carry crosses the whole word iff fully open
    c_in = carry_in_fn(prop, gen, reverse)
    run = _low_run(o) if not reverse else _high_run(o)
    return g | torch.where(c_in, run, torch.zeros((), dtype=run.dtype,
                                                  device=run.device))


def fill_round(o, r, carry_in_fn=_default_carry_in):
    """Six directional sweeps (+-X, +-Y, +-Z), the state carried through:
    one round subsumes a 6-neighbour dilation step, so the fixed point is
    BFS reachability, reached in about as many rounds as the hardest path
    changes direction."""
    r = _sweep_x(o, r, False, carry_in_fn)
    r = _sweep_x(o, r, True, carry_in_fn)
    for axis in (1, 2):
        for reverse in (False, True):
            r = _scan_semiring(o, r, axis, reverse)
    return r


def _max_rounds(o) -> int:
    """The round cap of the JAX package (``packfill.py:179,261``): the
    padded X extent plus Y plus Z, plus 2."""
    return int(o.shape[0] * 32 + o.shape[1] + o.shape[2]) + 2


def _changed(new, old) -> bool:
    return not torch.equal(new, old)


def packed_fill(o, r, max_rounds: int | None = None,
                carry_in_fn=_default_carry_in, changed_fn=_changed):
    """Fill rounds to the fixed point (the reach stops changing) or to
    ``max_rounds``.  One host read per round: the change test.
    ``carry_in_fn`` resolves the X sweeps' word-level carry (as in
    ``fill_round``); ``changed_fn(new, old) -> bool`` is the change test
    (a sharded fill's cross the ranks).  Where the JAX package's
    ``changed_fn`` reduces the elementwise change mask ``new != old``,
    this one takes both word volumes, as ``_double_fill``'s does.  Returns
    ``(reach, rounds)``."""
    if max_rounds is None:
        max_rounds = _max_rounds(o)
    rounds = 0
    changed = True
    while changed and rounds < max_rounds:
        new = fill_round(o, r, carry_in_fn)
        changed = changed_fn(new, r)
        r = new
        rounds += 1
    return r, rounds


def _double_fill(o, seeds_lo, outlet_seeds_fn, max_rounds: int,
                 carry_in_fn=_default_carry_in, changed_fn=_changed):
    """Inlet fill, then, at its fixed point, the open set becomes the
    inlet-reachable mask and the reach re-seeds from the outlet plane:
    the outlet fill restricted to the inlet-reachable set.  The stage
    logic and the cap of ``2 * max_rounds + 2`` rounds in all are the JAX
    package's ``_double_fill``, round for round: a volume past the cap
    stops where that loop stops.  One host read per round.

    ``outlet_seeds_fn(reach_in)`` returns the packed outlet-plane seeds
    restricted to ``reach_in``; ``carry_in_fn`` and ``changed_fn(new,
    old)`` (the sharded fill's cross the ranks).  Returns ``(active,
    rounds_total)``; the rounds also add to ``profiling.counters[
    "fill_rounds"]``."""
    o_cur, r, stage, changed, it = o, seeds_lo, 0, True, 0
    while (changed or stage == 0) and it < 2 * max_rounds + 2:
        new = fill_round(o_cur, r, carry_in_fn)
        ch = changed_fn(new, r)
        done0 = stage == 0 and not ch
        if done0:  # re-seed from the stage-0 fixed point itself
            o_cur, r, stage = new, outlet_seeds_fn(new), 1
        else:
            r = new
        changed = ch or done0
        it += 1
    profiling.counters["fill_rounds"] += it
    return r, it


def _face_seeds_packed(o, face: int, direction: int, word_offset: int = 0):
    """Packed seed mask: the open cells of the global plane
    ``{x,y,z}[direction] == face``.  ``word_offset`` is the global index
    of this block's first word (nonzero on a rank's slab)."""
    out = torch.zeros_like(o)
    if direction == 0:
        w, b = face // 32 - word_offset, face % 32
        if 0 <= w < o.shape[0]:
            torch.bitwise_and(o[w], _bit(b), out=out[w])
        return out
    sl = [slice(None)] * 3
    sl[direction] = face
    out[tuple(sl)] = o[tuple(sl)]
    return out


def percolation_oneshot_packed(phase_ok: torch.Tensor, direction: int):
    """Inlet fill, then the outlet fill restricted to the inlet-reachable
    set, on the packed words of the bool (X, Y, Z) ``phase_ok``, on its
    device.  Returns ``(active, n_active, rounds)``: the bool (X, Y, Z)
    mask, its cell count as a 0-d int64 tensor on the same device (no
    int32 total that could overflow), and the rounds both fills took."""
    X = phase_ok.shape[0]
    o = pack_x(phase_ok)
    seeds_lo = _face_seeds_packed(o, 0, direction)
    outlet = X - 1 if direction == 0 else phase_ok.shape[direction] - 1
    words, rounds = _double_fill(
        o, seeds_lo,
        lambda reach_in: _face_seeds_packed(reach_in, outlet, direction),
        _max_rounds(o))
    active = unpack_x(words, X)
    return active, active.sum(dtype=torch.int64), rounds



# ---------------------------------------------------------------------------
# The sharded driver: X slabs of words over the ranks of a Mesh
# (``openimpala_tpu/ops/packfill.py:271-399``)
# ---------------------------------------------------------------------------


def _shift_ones(x, k: int, reverse: bool):
    """One-filled shift along axis 0 (out of range counts as an open
    path): element i takes the value from i - k (forward) or i + k."""
    n = x.shape[0]
    out = torch.ones_like(x)
    if k < n:
        (d0, dn), (s0, sn) = _lo_hi(n, k, reverse)
        out.narrow(0, d0, dn).copy_(x.narrow(0, s0, sn))
    return out


def _prefix_and_exclusive(prop, reverse: bool):
    """pa[w] = AND of ``prop`` over the slab's words strictly before w in
    sweep order (True at the first word)."""
    a = prop
    n = prop.shape[0]
    k = 1
    while k < n:
        a = a & _shift_ones(a, k, reverse)
        k *= 2
    return _shift_ones(a, 1, reverse)


def _make_sharded_carry_in(mesh):
    """The word-level carry across ranks: the slab's own carry-lookahead,
    then each slab's summary, (A, B) = (a carry crosses the whole slab, the
    slab generates a carry), composed over the ranks in sweep order from
    one gather of two (Y, Z) planes per sweep.  The X sweeps are the only
    place the fill crosses a seam, so this is all of its traffic besides
    the fixed-point test."""

    def carry_in(prop, gen, reverse: bool):
        b_loc = _scan_semiring(prop, gen, 0, reverse)  # zero carry-in
        c_in_loc = _shift(b_loc, 1, 0, reverse)
        pa = _prefix_and_exclusive(prop, reverse)
        last = 0 if reverse else prop.shape[0] - 1
        summary = torch.stack([pa[last] & prop[last], b_loc[last]])
        parts = mesh.all_gather(summary)  # per rank: (A, B) planes
        order = (range(mesh.size) if not reverse
                 else range(mesh.size - 1, -1, -1))
        c = torch.zeros_like(b_loc[last])
        c_mine = c
        for s in order:  # exclusive compose in sweep order
            if s == mesh.rank:
                c_mine = c
            a_s, b_s = parts[s][0], parts[s][1]
            c = b_s | (a_s & c)
        return c_in_loc | (pa & c_mine)

    return carry_in


def percolation_oneshot_packed_sharded(phase_ok: torch.Tensor,
                                       direction: int, mesh,
                                       outlet: int | None = None):
    """The packed fill of ``percolation_oneshot_packed`` on this rank's X
    slab ``phase_ok`` (bool, on the mesh's device) of a volume decomposed
    over ``mesh``: the word carries cross the ranks through one gather of
    two (Y, Z) planes per X sweep, and the fixed-point test sums the
    ranks' changes (reference: parallelFloodFill's local fill and
    boundary exchange, ``TortuosityHypre.cpp:297-389``).

    ``outlet``: global index of the outlet plane along ``direction``
    (default the last; pass the original extent - 1 when X carries ingest
    padding).  Returns ``(active, counts, rounds)``: the slab's bool mask,
    the per-word-plane active counts (int64, (X_local/32,); their sum
    over the ranks is the active-cell count) and the rounds, or None where
    the layout is
    not supported: X not divisible by 32 times the ranks (the JAX
    package's rule)."""
    n = mesh.size
    xl = phase_ok.shape[0]
    X = xl * n
    if X % (32 * n) != 0:
        return None
    out_face = (X if direction == 0 else phase_ok.shape[direction]) - 1
    if outlet is not None:
        out_face = int(outlet)
    offset = mesh.rank * (xl // 32)  # this slab's first word

    def changed(new, old):
        diff = torch.ne(new, old).any().to(torch.int64)
        return bool(mesh.allsum(diff) > 0)

    # the round cap of the GLOBAL sum(dims) + 2 (TortuosityHypre.cpp:328)
    max_rounds = X + phase_ok.shape[1] + phase_ok.shape[2] + 2
    o = pack_x(phase_ok)
    seeds_lo = _face_seeds_packed(o, 0, direction, offset)
    words, rounds = _double_fill(
        o, seeds_lo,
        lambda reach_in: _face_seeds_packed(reach_in, out_face, direction,
                                            offset),
        max_rounds, carry_in_fn=_make_sharded_carry_in(mesh),
        changed_fn=changed)
    active = unpack_x(words, xl)
    counts = active.reshape(xl // 32, -1).sum(dim=1, dtype=torch.int64)
    return active, counts, rounds

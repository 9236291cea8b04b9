"""The Huffman stage of the wire format, in plain Python.

A whole inner stream is coded byte by byte: a dict of groups, each
[1-bit has-items = 1][7-bit group length][4-bit code length] then per
entry [8-bit symbol][code], ended by one 0 bit; then every inner byte's
code, MSB-first.  Where that is not smaller than the inner stream, the
stream is [0 bit][the inner bytes] instead.

The codes are fixed by these rules, which make the dict deterministic:

  * the tree merges the two smallest entries of a heap ordered by
    (frequency, smallest symbol under the node, node id), leaves first in
    symbol order; a merged node takes the next id;
  * a symbol's length is its depth (at least 1); lengths past 15 are
    folded back JPEG-style: a pair at the deepest level moves up one, paid
    for by splitting a code at the deepest occupied level two or more
    above it; then the new lengths go to the symbols in the order of their
    old lengths (stable in symbol order);
  * codes are canonical: shorter first, then by symbol;
  * groups go longest code first, entries by symbol, at most 127 a group.
"""

from __future__ import annotations

import heapq

MAX_CODE_LEN = 15
MAX_GROUP = 127


def _tree_depths(counts: list[int]) -> list[int] | None:
    """Each symbol's depth in the Huffman tree (0 for an absent symbol),
    or None for fewer than two symbols."""
    syms = [s for s in range(256) if counts[s] > 0]
    if len(syms) < 2:
        return None
    heap = [(counts[s], s, i) for i, s in enumerate(syms)]
    heapq.heapify(heap)
    parent = {}
    next_id = len(syms)
    while len(heap) > 1:
        f1, t1, a = heapq.heappop(heap)
        f2, t2, b = heapq.heappop(heap)
        parent[a] = parent[b] = next_id
        heapq.heappush(heap, (f1 + f2, min(t1, t2), next_id))
        next_id += 1
    depth = {next_id - 1: 0}
    for node in range(next_id - 2, -1, -1):  # a parent's id is larger
        depth[node] = depth[parent[node]] + 1
    out = [0] * 256
    for i, s in enumerate(syms):
        out[s] = max(depth[i], 1)
    return out


def _limit(lengths: list[int]) -> list[int]:
    """Lengths folded under MAX_CODE_LEN (see the module docstring)."""
    top = max(lengths)
    hist = [0] * (top + 1)
    for ln in lengths:
        if ln:
            hist[ln] += 1
    for ln in range(top, MAX_CODE_LEN, -1):
        while hist[ln] > 1:
            j = ln - 2
            while j > 0 and hist[j] == 0:
                j -= 1
            if j == 0:
                raise ValueError("no code profile within 15 bits")
            hist[ln] -= 2
            hist[ln - 1] += 1
            hist[j + 1] += 2
            hist[j] -= 1
        if hist[ln] == 1:
            raise ValueError("no code profile within 15 bits")
    order = sorted((s for s in range(256) if lengths[s]),
                   key=lambda s: (lengths[s], s))
    new = []
    for ln, n in enumerate(hist):
        new += [ln] * max(n, 0)
    out = [0] * 256
    for s, ln in zip(order, new):
        out[s] = ln
    return out


def code_table(counts: list[int]):
    """(dict fields [(value, nbits)], codes [256], lengths [256]) for a
    byte histogram, or None for fewer than two symbols."""
    lengths = _tree_depths(counts)
    if lengths is None:
        return None
    if max(lengths) > MAX_CODE_LEN:
        lengths = _limit(lengths)
    codes = [0] * 256
    code = prev = 0
    used = sorted({ln for ln in lengths if ln})
    for ln in used:
        code <<= ln - prev
        prev = ln
        for s in range(256):
            if lengths[s] == ln:
                codes[s] = code
                code += 1
    fields = []
    for ln in reversed(used):
        syms = [s for s in range(256) if lengths[s] == ln]
        for at in range(0, len(syms), MAX_GROUP):
            chunk = syms[at:at + MAX_GROUP]
            fields += [(0x80 | len(chunk), 8), (ln, 4)]
            for s in chunk:
                fields += [(s, 8), (codes[s], ln)]
    fields.append((0, 1))
    return fields, codes, lengths

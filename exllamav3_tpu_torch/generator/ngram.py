"""Suffix-automaton n-gram drafting (counterpart of
exllamav3_tpu/generator/ngram.py).

An incremental suffix automaton over a job's token stream proposes, as draft
tokens, what followed the longest earlier occurrence of the stream's current
suffix. Host code. The JAX package prefers its C++ automaton
(native/exl3_native.cpp) when it is built; the port keeps this Python one,
which drafts the same tokens.
"""
from __future__ import annotations


class SuffixAutomaton:
    """Online suffix automaton over a token sequence, with one sample end
    position per state, so that 'what followed this context last time' is a
    lookup of O(draft length)."""

    def __init__(self):
        self.next: list[dict] = [{}]
        self.link: list[int] = [-1]
        self.length: list[int] = [0]
        self.endpos: list[int] = [-1]  # sample end position of the state
        self.last = 0
        self.tokens: list[int] = []

    def extend(self, token: int):
        t = int(token)
        self.tokens.append(t)
        pos = len(self.tokens) - 1
        cur = len(self.next)
        self.next.append({})
        self.link.append(-1)
        self.length.append(self.length[self.last] + 1)
        self.endpos.append(pos)
        p = self.last
        while p != -1 and t not in self.next[p]:
            self.next[p][t] = cur
            p = self.link[p]
        if p == -1:
            self.link[cur] = 0
        else:
            q = self.next[p][t]
            if self.length[p] + 1 == self.length[q]:
                self.link[cur] = q
            else:
                clone = len(self.next)
                self.next.append(dict(self.next[q]))
                self.link.append(self.link[q])
                self.length.append(self.length[p] + 1)
                self.endpos.append(self.endpos[q])
                while p != -1 and self.next[p].get(t) == q:
                    self.next[p][t] = clone
                    p = self.link[p]
                self.link[q] = clone
                self.link[cur] = clone
        self.last = cur

    def draft(self, max_tokens: int, min_context: int = 2) -> list[int]:
        """Up to max_tokens tokens that followed the longest earlier
        occurrence (at least min_context long) of the current suffix."""
        if len(self.tokens) < min_context + 1:
            return []
        # walk suffix links until a state ends strictly before the current
        # end, i.e. the suffix occurred before
        s = self.link[self.last]
        n = len(self.tokens)
        while s > 0:
            ep = self.endpos[s]
            if self.length[s] >= min_context and ep < n - 1:
                return self.tokens[ep + 1: ep + 1 + max_tokens]
            s = self.link[s]
        return []

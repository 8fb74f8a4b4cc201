"""Device-side n-gram draft lookup for speculative decode.

Find the latest earlier occurrence of the trailing n-gram that ends at the
current token and replay the tokens that followed it; with no match, repeat
the current token. Verification restores exactness, so greedy outputs do not
depend on draft quality. Drafts are integers and match the reference
exactly, including its index arithmetic: ``hist[b, pos - 1]`` at ``pos = 0``
wraps to the last column, as a negative JAX index does.
"""
from __future__ import annotations

import torch


def build_ngram_draft(hist_len: int, k_spec: int, ngram: int):
    """Return ``draft(hist, cur, pos) -> (S, k_spec)`` int32 drafts.

    hist: (S, hist_len) per-slot token history with ``hist[b, :pos[b]+1]``
    the verified stream including ``cur`` at ``pos``; cur/pos: (S,) int32.
    No host syncs; shapes are static in ``k_spec``.
    """
    if ngram not in (2, 3):
        raise ValueError(f"ngram must be 2 (bigram) or 3 (trigram), got "
                         f"{ngram}")

    def draft(hist, cur, pos):
        s = hist.shape[0]
        dev = hist.device
        pos = pos.long()
        bidx = torch.arange(s, device=dev)
        # Latest earlier occurrence of the trailing bigram (hist[pos-1], cur).
        prev = hist[bidx, (pos - 1) % hist_len]
        hit = (hist[:, :-1] == prev[:, None]) & (hist[:, 1:] == cur[:, None])
        j = torch.arange(hist_len - 1, device=dev)
        # the match ends at j+1; only strictly-earlier ends count
        cand = torch.where(hit & ((j + 1)[None, :] < pos[:, None]), j, -1)
        best = cand.max(dim=1).values
        src = torch.where(best >= 0, best + 2, pos + 1)
        if ngram == 3:
            # Trigram keys, falling back to the bigram match above.
            p2 = hist[bidx, (pos - 2).clamp_min(0)]
            hit3 = (hist[:, :-2] == p2[:, None]) & \
                   (hist[:, 1:-1] == prev[:, None]) & \
                   (hist[:, 2:] == cur[:, None])
            j3 = torch.arange(hist_len - 2, device=dev)
            cand3 = torch.where(hit3 & ((j3 + 2)[None, :] < pos[:, None])
                                & (pos[:, None] >= 2), j3, -1)
            best3 = cand3.max(dim=1).values
            src = torch.where(best3 >= 0, best3 + 3, src)
        # A recent match reaching past the known history is extrapolated
        # periodically: indices beyond pos wrap back by the match distance.
        period = (pos - (src - 1)).clamp_min(1)
        q_idx = src[:, None] + torch.arange(k_spec, device=dev)[None, :]
        over = (q_idx - pos[:, None]).clamp_min(0)
        wrap = torch.div(over + period[:, None] - 1, period[:, None],
                         rounding_mode="floor")
        didx = q_idx - wrap * period[:, None]
        return hist[bidx[:, None], didx.clamp(0, hist_len - 1)].to(torch.int32)

    return draft

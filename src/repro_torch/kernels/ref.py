"""Plain PyTorch versions of the kernels (the correctness contracts).

Each mirrors its CUDA kernel's semantics exactly; the KG executor's two
(``rank_join_lookup``, ``merge_topk``) are batched over a leading group
axis G. The CPU path runs these, the CUDA kernels are held against them on
the card, and the tests hold them against ``repro.kernels.ref``.
"""
from __future__ import annotations

import torch

PAD_KEY = -1


def rank_join_lookup(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
                     probe_keys: torch.Tensor, seen_cnt: torch.Tensor):
    """Probe keys against unique-key scored seen buffers, one per group.

    seen_keys (G, N) i32, seen_scores (G, N) f32, probe_keys (G, B) i32,
    seen_cnt (G,) i32. Slot n of group g is live iff n < seen_cnt[g] and
    its key is not PAD_KEY. Returns (scores (G, B) f32 — the sum of the
    live matches' scores, 0 where none — and found (G, B) bool; PAD probes
    are never found).
    """
    n = seen_keys.shape[-1]
    pos = torch.arange(n, device=seen_keys.device)
    valid = (seen_keys != PAD_KEY) & (pos[None, :] < seen_cnt[:, None])
    eq = (probe_keys[:, :, None] == seen_keys[:, None, :]) & valid[:, None, :]
    scores = torch.where(eq, seen_scores[:, None, :], 0.0).sum(-1)
    found = eq.any(-1) & (probe_keys != PAD_KEY)
    return torch.where(found, scores, 0.0), found


def merge_topk(window_keys: torch.Tensor, window_scores: torch.Tensor,
               block: int):
    """Top-``block`` of each group's R source windows by score, descending.

    window_keys (G, R, W) i32, window_scores (G, R, W) f32. Ties go to the
    lower flat index (r·W + w), as ``lax.top_k`` orders them. Returns
    (keys (G, block) i32, scores (G, block) f32, flat_idx (G, block) i32).
    """
    G = window_keys.shape[0]
    flat_k = window_keys.reshape(G, -1)
    flat_s = window_scores.reshape(G, -1)
    top_s, top_i = torch.sort(flat_s, dim=-1, descending=True, stable=True)
    top_s, top_i = top_s[:, :block], top_i[:, :block]
    return (flat_k.gather(1, top_i), top_s.contiguous(),
            top_i.to(torch.int32))


def rank_join_lookup_split(seen_keys: torch.Tensor, seen_scores: torch.Tensor,
                           probe_keys: torch.Tensor, seen_cnt: torch.Tensor,
                           chunks: int):
    """The CUDA kernel's schedule of ``rank_join_lookup`` (a model for the
    tests; it returns what the plain version does).

    Per group: the B probe keys sorted into a table, duplicates and PAD keys
    kept (a key's entry is its first position, a lower bound); the live
    prefix min(N, seen_cnt) cut into ``chunks`` equal chunks of a multiple
    of 4 slots; in each chunk every live non-PAD slot finds its entry by
    lower bound and, on a hit, adds its score to that entry's sum and
    counts it; then each probe sums its entry over the chunks in order,
    from 0.0 (an empty chunk adds 0), and is found where the count is > 0
    and it is not PAD.
    """
    G, N = seen_keys.shape
    B = probe_keys.shape[1]
    scores = torch.zeros((G, B), dtype=torch.float32)
    found = torch.zeros((G, B), dtype=torch.bool)
    for g in range(G):
        live = min(N, max(int(seen_cnt[g]), 0))
        if live == 0:
            continue
        table = torch.sort(probe_keys[g]).values
        chunk = (-(-live // chunks) + 3) & ~3
        total = torch.zeros(B, dtype=torch.float32)
        hits = torch.zeros(B, dtype=torch.int64)
        for c in range(chunks):
            lo, hi = min(live, c * chunk), min(live, (c + 1) * chunk)
            if lo >= hi:
                break
            k, s = seen_keys[g, lo:hi], seen_scores[g, lo:hi]
            e = torch.searchsorted(table, k).clamp(max=B - 1)
            hit = (k != PAD_KEY) & (table[e] == k)
            acc = torch.zeros(B, dtype=torch.float32).index_add_(
                0, e[hit], s[hit])
            total = total + acc
            hits = hits.index_add_(0, e[hit], torch.ones_like(e[hit]))
        e = torch.searchsorted(table, probe_keys[g])
        found[g] = (hits[e] > 0) & (probe_keys[g] != PAD_KEY)
        scores[g] = torch.where(found[g], total[e], 0.0)
    return scores.to(seen_scores.device), found.to(seen_keys.device)


def merge_topk_ranked(window_keys: torch.Tensor, window_scores: torch.Tensor,
                      block: int):
    """The CUDA kernel's schedule of ``merge_topk`` (a model for the tests;
    it returns what the plain version does, and how many rows it sorted).

    Each row whose scores are non-increasing is taken as it is (its flat
    indices are then in position order); any other row is sorted by (score
    desc, flat index asc). An item's rank is its position in its row plus,
    for every other row, the count of that row's items before it in the
    total order: scores >= its score in a lower row, > it in a higher one.
    The item of rank j < block fills output slot j.
    """
    G, R, W = window_keys.shape
    out_k = torch.full((G, block), PAD_KEY, dtype=torch.int32)
    out_s = torch.full((G, block), float("nan"))
    out_i = torch.full((G, block), -1, dtype=torch.int32)
    n_sorted = 0
    for g in range(G):
        rows_s, rows_i = [], []
        for q in range(R):
            s = window_scores[g, q].cpu()
            i = q * W + torch.arange(W, dtype=torch.int32)
            if not bool((s[:-1] >= s[1:]).all()):
                s, perm = torch.sort(s, descending=True, stable=True)
                i = i[perm]
                n_sorted += 1
            rows_s.append(s)
            rows_i.append(i)
        for r in range(R):
            x = rows_s[r]
            rank = torch.arange(W)
            for q in range(R):
                if q != r:  # counts in a non-increasing row, from the top
                    rank = rank + torch.searchsorted(-rows_s[q], -x,
                                                     right=q < r)
            take = rank < block
            out_s[g, rank[take]] = x[take]
            out_i[g, rank[take]] = rows_i[r][take]
        out_k[g] = window_keys[g].reshape(-1).cpu()[out_i[g].long()]
    dev = window_keys.device
    return out_k.to(dev), out_s.to(dev), out_i.to(dev), n_sorted


def topk_score(query: torch.Tensor, cands: torch.Tensor, k: int):
    """Full-scan oracle: dot-score one query against every candidate.

    query (D,) f32, cands (N, D) f32. Returns (scores (k,) f32, idx (k,)
    i32), ties to the lower index as ``lax.top_k`` orders them.
    """
    top_s, top_i = torch.sort(cands @ query, descending=True, stable=True)
    return top_s[:k].contiguous(), top_i[:k].to(torch.int32)


def topk_score_pruned(query: torch.Tensor, cands: torch.Tensor,
                      block_bounds: torch.Tensor, k: int, tile: int):
    """Speculative top-k: visit the tiles of ``cands`` in order and skip a
    tile when its score upper bound is ≤ the running k-th score.

    query (D,) f32, cands (N, D) f32 with N % tile == 0, block_bounds
    (N/tile,) f32. The buffer goes before the tile in every merge and the
    merge is a stable sort, so ties keep the lower index (``lax.top_k``'s
    order). Returns (scores (k,) f32, idx (k,) i32 with -1 where fewer than
    k were scored, n_tiles_scored () i32).
    """
    n, _ = cands.shape
    if n % tile:
        raise ValueError(f"N = {n} is not a multiple of tile = {tile}")
    dev = cands.device
    buf_s = torch.full((k,), float("-inf"), device=dev)
    buf_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    scored = torch.zeros((), dtype=torch.int32, device=dev)
    offs = torch.arange(tile, dtype=torch.int32, device=dev)
    for j in range(n // tile):
        run = block_bounds[j] > buf_s[k - 1]
        tile_s = cands[j * tile:(j + 1) * tile] @ query
        tile_s = torch.where(run, tile_s, float("-inf"))
        cat_s = torch.cat([buf_s, tile_s])
        cat_i = torch.cat([buf_i, j * tile + offs])
        top_s, top_j = torch.sort(cat_s, descending=True, stable=True)
        buf_s, buf_i = top_s[:k], cat_i[top_j[:k]]
        scored = scored + run.to(torch.int32)
    return buf_s.contiguous(), buf_i, scored


def _merge(buf_s, buf_i, list_s, list_i, k: int):
    """Top-k of the buffer and one or more lists by (score desc, index
    asc); the buffer's empty slots (-inf, -1) come before any list entry."""
    cat_s, cat_i = torch.cat([buf_s, list_s]), torch.cat([buf_i, list_i])
    by_i = torch.sort(cat_i, stable=True).indices
    by_s = torch.sort(cat_s[by_i], descending=True, stable=True).indices
    top = by_i[by_s[:k]]
    return cat_s[top], cat_i[top]


def topk_score_pruned_speculative(query: torch.Tensor, cands: torch.Tensor,
                                  block_bounds: torch.Tensor, k: int,
                                  tile: int, wave: int,
                                  room: int | None = None,
                                  probe: int | None = None):
    """The CUDA kernel's schedule of ``topk_score_pruned``, in waves of
    ``wave`` tiles (a model for the tests; it returns what the sequential
    version does).

    Each wave reads, in any order, the tiles whose bound beats the k-th
    the replay had published when the wave began (a kth_i with i ≤ j, so
    no tile the sequential order scores is left unread). A read tile keeps
    its top min(k, tile) dots above that k-th, sorted by (score desc, index
    asc). Then the replay visits the wave's tiles in order: a read tile
    counts when bound > the running k-th, and only then is its list merged,
    when its first entry beats the k-th.

    ``probe`` bounds each list's live entries as the kernel does: when a
    wave's replay begins, a list longer than ``probe`` whose entry at
    ``probe`` is at or below the k-th keeps its first ``probe`` entries
    (the others cannot enter).

    ``room`` (list entries) turns on the kernel's batch merges: from the
    next tile to merge, ``at``, the following tiles join while the batch's
    lists hold at most ``room`` entries; a read tile whose bound beats the
    current k-th counts and merges as above, the others are neither; the
    batch ends after its last list. It merges all its lists at once and
    holds if each tile after ``at`` that counts has bound > the merged
    k-th. Where ``at``'s list is shorter than k, a list joins only if, with
    C the batch's list entries up to it, C < k and those tiles' bounds beat
    the buffer's (k - C)-th score, an upper bound of the merged k-th: the
    batch holds. Otherwise, if it does not hold, it is planned again up to
    its first tile with bound ≤ the merged k-th, and that batch holds; so
    does every later batch inside the failed one's tiles, planned with that
    k-th as the limit. (The kernel merges a batch of fewer than four lists
    list by list: the same result.)

    Returns (scores (k,), idx (k,), n_tiles_scored () i32, tiles read).
    """
    n, _ = cands.shape
    if n % tile:
        raise ValueError(f"N = {n} is not a multiple of tile = {tile}")
    dev = cands.device
    buf_s = torch.full((k,), float("-inf"), device=dev)
    buf_i = torch.full((k,), -1, dtype=torch.int32, device=dev)
    scored, read, m = 0, 0, min(k, tile)
    n_tiles = n // tile
    for w0 in range(0, n_tiles, wave):
        w1 = min(w0 + wave, n_tiles)
        published = buf_s[k - 1]
        lists = {}
        for j in range(w0, w1):
            if not block_bounds[j] > published:
                continue
            read += 1
            tile_s = cands[j * tile:(j + 1) * tile] @ query
            top_s, top_j = torch.sort(tile_s, descending=True, stable=True)
            keep = top_s[:m] > published
            lists[j] = (top_s[:m][keep],
                        (j * tile + top_j[:m][keep]).to(torch.int32))

        kth0 = buf_s[k - 1]
        for j, (list_s, list_i) in lists.items():
            if probe is not None and len(list_s) > probe and not (
                    list_s[probe] > kth0):
                lists[j] = (list_s[:probe], list_i[:probe])

        def counted(j, kth):
            return j in lists and bool(block_bounds[j] > kth)

        def merges(j, kth):
            return (counted(j, kth) and len(lists[j][0]) > 0
                    and bool(lists[j][0][0] > kth))

        def plan(at, kth, limit, sure, cap):
            """(tiles to merge, tiles after ``at`` that count, their least
            bound, end) of the batch from ``at``, before tile ``cap``."""
            batch, n_after, least, end = [at], 0, float("inf"), at + 1
            pend_n, pend_least = 0, float("inf")
            entries = len(lists[at][0])
            for j in range(at + 1, cap):
                if entries >= room or (not sure and counted(j, kth)
                                       and not block_bounds[j] > limit):
                    break
                if merges(j, kth):
                    low = min(least, pend_least, float(block_bounds[j]))
                    more = entries + len(lists[j][0])
                    if more > room or sure and not (
                            more < k and low > buf_s[k - 1 - more]):
                        break
                    batch.append(j)
                    entries = more
                    n_after += pend_n + 1
                    least, pend_n, pend_least, end = low, 0, float("inf"), j + 1
                elif counted(j, kth):
                    pend_n += 1
                    pend_least = min(pend_least, float(block_bounds[j]))
            return batch, n_after, least, end

        def merge_batch(batch, kth):
            keep = [lists[j][0] > kth for j in batch]
            return _merge(
                buf_s, buf_i,
                torch.cat([lists[j][0][c] for j, c in zip(batch, keep)]),
                torch.cat([lists[j][1][c] for j, c in zip(batch, keep)]), k)

        pos, fail_end, fail_kth = w0, w0, None
        while pos < w1:
            kth = buf_s[k - 1]
            at = next((j for j in range(pos, w1) if merges(j, kth)), w1)
            scored += sum(counted(j, kth) for j in range(pos, at))
            if at == w1:
                break
            scored += 1
            sure = len(lists[at][0]) < k and at >= fail_end
            if not room:
                batch, n_after, least, end = [at], 0, 0.0, at + 1
            elif at < fail_end:
                batch, n_after, least, end = plan(at, kth, fail_kth, False,
                                                  fail_end)
            else:
                batch, n_after, least, end = plan(at, kth, kth, sure, w1)
            if len(batch) > 1:
                new_s, new_i = merge_batch(batch, kth)
                if not least > new_s[k - 1]:
                    assert not sure and at >= fail_end
                    fail_end, fail_kth = end, new_s[k - 1]
                    batch, n_after, least, end = plan(at, kth, fail_kth,
                                                      False, w1)
                    if len(batch) > 1:
                        new_s, new_i = merge_batch(batch, kth)
                        assert least > new_s[k - 1]
            if len(batch) > 1:
                buf_s, buf_i = new_s, new_i
                scored += n_after
                pos = end
            else:
                buf_s, buf_i = _merge(buf_s, buf_i, *lists[at], k)
                pos = at + 1
    return (buf_s.contiguous(), buf_i,
            torch.tensor(scored, dtype=torch.int32, device=dev), read)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: torch.Tensor):
    """Weighted multi-hot bag: out[b] = Σ_s w[b,s]·table[ids[b,s]].

    table (V, D) f32, ids (B, S) i32 (negative = inactive slot), weights
    (B, S) f32 → (B, D) f32.
    """
    ok = ids >= 0
    gathered = table[torch.where(ok, ids, 0).long()]          # (B, S, D)
    w = torch.where(ok, weights, 0.0)
    return torch.einsum("bsd,bs->bd", gathered, w)


def embedding_bag_backward(dout: torch.Tensor, ids: torch.Tensor,
                           weights: torch.Tensor, table: torch.Tensor, *,
                           table_grad: bool = True,
                           weights_grad: bool = False):
    """The bag's gradients: dtable[ids[b,s]] += w[b,s]·dout[b] over the
    live slots (``index_add_`` of the weighted rows into a zero (V, D)
    array), and dweights[b,s] = ⟨table[ids[b,s]], dout[b]⟩ (0 where
    ids < 0). Returns (dtable or None, dweights or None)."""
    ok = ids >= 0
    dtable = dweights = None
    if table_grad:
        live = ok.reshape(-1)
        rows = (dout[:, None, :] * weights[..., None]).reshape(
            -1, dout.shape[1])[live]
        dtable = torch.zeros(table.shape, dtype=torch.float32,
                             device=dout.device).index_add_(
            0, ids.reshape(-1)[live].long(), rows)
    if weights_grad:
        gathered = table[torch.where(ok, ids, 0).long()]      # (B, S, D)
        dweights = torch.where(ok, (gathered * dout[:, None, :]).sum(-1),
                               0.0)
    return dtable, dweights


def neigh_softmax_agg(logits: torch.Tensor, feats: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """Fused edge softmax + neighbourhood aggregation (the GAT hot loop)
    on the padded-degree layout.

    logits (R, MAXD) f32, feats (R, MAXD, D) f32, mask (R, MAXD) bool →
    (R, D) f32: Σ_j softmax_j(logits[r] over the live slots) · feats[r, j].
    A row with no live slot gives 0.
    """
    ml = torch.where(mask, logits, float("-inf"))
    mx = ml.max(dim=1, keepdim=True).values
    mx = torch.where(torch.isfinite(mx), mx, 0.0)
    ex = torch.where(mask, torch.exp(ml - mx), 0.0)
    den = ex.sum(dim=1, keepdim=True)
    w = ex / torch.clamp(den, min=1e-30)
    return torch.einsum("nd,ndk->nk", w, feats)


AGG_CHUNK = 64  # slots of a row that one pass of csrc/neigh_agg.cu takes


def agg_lanes(D: int, vec: int):
    """``csrc/neigh_agg.cu``'s lanes for D floats a slot read in vectors of
    ``vec`` floats: (LPS lanes a slot, KC vectors a lane, LPR lanes a row,
    column tiles)."""
    units = D // vec
    if units <= 32:
        lps = 1
        while lps < units:
            lps <<= 1
        return lps, 1, max(lps, 8), 1
    if units <= 48:
        return 16, 3, 32, 1
    if units <= 64:
        return 32, 2, 32, 1
    return 32, 4, 32, -(-units // 128)


def _xor_tree(v: torch.Tensor, offsets) -> torch.Tensor:
    """Lanes on the last axis; at each offset o every lane adds lane i ^ o
    (a shuffle xor), so all lanes end with the same sum."""
    idx = torch.arange(v.shape[-1])
    for o in offsets:
        v = v + v[..., idx ^ o]
    return v


def neigh_softmax_agg_grouped(logits: torch.Tensor, feats: torch.Tensor,
                              mask: torch.Tensor, vec: int | None = None):
    """The CUDA kernel's schedule of ``neigh_softmax_agg`` (a model for the
    tests; within the reference's rtol 1e-4 atol 1e-5 of the plain version).
    Returns (out, the (row, slot) pairs whose features it read).

    Rows go in groups of 32 / LPR (the last group ragged: its missing rows
    read nothing). Lane l of a row holds slots c·64 + t·LPR + l of pass c;
    the max and the sum of exponentials go over every pass, a lane's sum in
    pass-then-step order, then over the row's lanes by an xor tree. Each
    pass packs its live slots in slot order into a list with weight
    e / den; the row's LPR / LPS slot groups take list entries g, g + G,
    ... and add w · x in that order, reading only those slots' features;
    the groups' partial sums then meet in an xor tree (offsets 1, 2, ...).
    ``vec`` is the vector width the kernel picks from D and the pointers'
    alignment (4, 2 or 1); it changes the lanes, not the sums' order.
    """
    R, MAXD = logits.shape
    D = feats.shape[-1]
    if vec is None:
        vec = 4 if D % 4 == 0 else 2 if D % 2 == 0 else 1
    lps, _, lpr, _ = agg_lanes(D, vec)
    G, T = lpr // lps, AGG_CHUNK // lpr
    nch = -(-MAXD // AGG_CHUNK)
    rpw = 32 // lpr
    Rp = -(-R // rpw) * rpw                       # the ragged last group
    lg = torch.zeros((Rp, nch * AGG_CHUNK))
    mk = torch.zeros((Rp, nch * AGG_CHUNK), dtype=torch.bool)
    lg[:R, :MAXD] = logits.cpu()
    mk[:R, :MAXD] = mask.cpu()
    lane_lg = lg.view(Rp, nch, T, lpr)            # [row, pass, step, lane]
    lane_mk = mk.view(Rp, nch, T, lpr)
    mx = torch.where(lane_mk, lane_lg, float("-inf")).amax(dim=(1, 2, 3))
    mx = torch.where(mx == float("-inf"), 0.0, mx)
    ex = torch.where(lane_mk, torch.exp(lane_lg - mx[:, None, None, None]),
                     0.0)
    den = torch.zeros((Rp, lpr))
    for c in range(nch):
        for t in range(T):
            den = den + ex[:, c, t]
    offs = []
    o = lpr // 2
    while o:
        offs.append(o)
        o //= 2
    den = _xor_tree(den, offs)[:, 0].clamp(min=1e-30)

    fc = feats.cpu()
    acc = torch.zeros((Rp, G, D))
    read = []
    for c in range(nch):
        live = mk[:, c * AGG_CHUNK:(c + 1) * AGG_CHUNK]
        cnt = live.sum(1)
        # The pass's list: live slots in slot order, weights e / den.
        order = torch.sort((~live).to(torch.int8), dim=1, stable=True).indices
        slot = c * AGG_CHUNK + order
        w = ex.view(Rp, -1)[:, c * AGG_CHUNK:(c + 1) * AGG_CHUNK].gather(
            1, order) / den[:, None]
        for k in range(-(-AGG_CHUNK // G)):
            s = k * G + torch.arange(G)                         # (G,)
            on = s[None, :] < cnt[:, None]                      # (Rp, G)
            r_i, g_i = torch.nonzero(on, as_tuple=True)
            j = slot[r_i, s[g_i]]
            x = torch.zeros((Rp, G, D))
            x[r_i, g_i] = fc[r_i, j]                            # live only
            read += list(zip(r_i.tolist(), j.tolist()))
            ws = torch.zeros((Rp, G))
            ws[r_i, g_i] = w[r_i, s[g_i]]
            acc = acc + ws[..., None] * x
    offs = []
    o = 1
    while o < G:
        offs.append(o)
        o *= 2
    out = _xor_tree(acc.transpose(1, 2), offs)[..., 0]          # (Rp, D)
    return out[:R].to(logits.device), read


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    softcap: float | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention with GQA, a causal mask, a sliding window and a softcap.

    q (B, Hq, Sq, D); k, v (B, Hkv, Sk, D) with Hq % Hkv == 0. Query i
    sits at key position Sk − Sq + i; with ``window`` W it sees the keys
    in (pos − W, pos]. The logits are scaled, then softcapped. Computed in
    f32 (``repro.kernels.ref.flash_attention_ref``'s math), returned in
    q's dtype; a row with no visible key gives 0.
    """
    dt = q.dtype
    Hq, Sq, D = q.shape[1:]
    Sk = k.shape[2]
    g = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk).mul_(scale)
    if softcap:
        logits = logits.div_(softcap).tanh_().mul_(softcap)
    qpos = Sk - Sq + torch.arange(Sq, device=q.device)
    kpos = torch.arange(Sk, device=q.device)
    m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        m &= kpos[None, :] <= qpos[:, None]
    if window:
        m &= kpos[None, :] > qpos[:, None] - window
    p = torch.softmax(logits.masked_fill_(~m, float("-inf")), dim=-1)
    p = p.nan_to_num_(nan=0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(dt)


def flash_attention_tiles(Sq: int, Sk: int, causal: bool, window: int,
                          BM: int, BN: int) -> list[tuple[int, int, bool]]:
    """The (q-tile, k-tile, masked) triples the CUDA ``flash_attention``
    visits, in its order: q-tiles of BM rows (one consumer warpgroup's),
    each walking the BN-key tiles of its rows' causal / window band
    (``band`` in ``csrc/flash_attention.cu``); ``masked`` is the kernel's
    ``edge``: the tile meets the band's edge or the ragged end of the keys.
    Used by the tests, never on the main path."""
    off = Sk - Sq
    out = []
    for qt in range(-(-Sq // BM)):
        r0, r1 = qt * BM, min(qt * BM + BM, Sq)
        k_lo = max(0, off + r0 - window + 1) if window > 0 else 0
        k_hi = min(Sk - 1, off + r1 - 1) if causal else Sk - 1
        if k_hi < k_lo:
            continue
        for kt in range(k_lo // BN, k_hi // BN + 1):
            k0 = kt * BN
            edge = (k0 + BN > Sk or (causal and k0 + BN - 1 > off + r0)
                    or (window > 0 and k0 <= off + r1 - 1 - window))
            out.append((qt, kt, edge))
    return out


def flash_attention_blocked(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int | None = None,
                            softcap: float | None = None,
                            scale: float | None = None, BM: int = 64,
                            BN: int = 80) -> torch.Tensor:
    """A plain model of the CUDA ``flash_attention``'s arithmetic, same
    arguments as ``flash_attention``: the tiles of ``flash_attention_tiles``
    in order, logits in the log2 domain (cexp · tanh(mul · s) with the
    softcap, cexp · s without, cexp folding log2 e), the online max and
    rescale per tile with the m_safe / alpha handling of -inf, p rounded to
    bf16 before p·v, each tile's p·v added before the next tile's rescale,
    and the division by max(l, 1e-30). Used by the tests, never on the
    main path."""
    B, Hq, Sq, D = q.shape
    Sk = k.shape[2]
    g = Hq // k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    log2e = 1.4426950408889634
    mul = scale / softcap if softcap else 0.0
    cexp = (softcap if softcap else scale) * log2e
    win = int(window or 0)
    kk = k.float().repeat_interleave(g, dim=1)
    vv = v.float().repeat_interleave(g, dim=1)
    out = torch.zeros(q.shape, dtype=torch.float32)
    keys = torch.arange(BN)
    tiles: dict[int, list] = {}
    for qt, kt, edge in flash_attention_tiles(Sq, Sk, causal, win, BM, BN):
        tiles.setdefault(qt, []).append((kt, edge))
    for qt, visits in tiles.items():
        rows = slice(qt * BM, min(qt * BM + BM, Sq))
        qb = q[:, :, rows].float()
        qpos = Sk - Sq + torch.arange(rows.start, rows.stop)
        m = torch.full(qb.shape[:3], float("-inf"))
        l = torch.zeros(qb.shape[:3])
        acc = torch.zeros(qb.shape)
        pending = None                      # the previous tile's (p, v)
        for kt, edge in visits:
            ks = slice(kt * BN, min(kt * BN + BN, Sk))
            x = qb @ kk[:, :, ks].transpose(-1, -2)
            if softcap:
                x = torch.tanh(x * mul)
            if edge:
                key = kt * BN + keys[:ks.stop - ks.start]
                ok = torch.ones((len(qpos), len(key)), dtype=torch.bool)
                if causal:
                    ok &= key[None, :] <= qpos[:, None]
                if win:
                    ok &= key[None, :] > qpos[:, None] - win
                x = x.masked_fill(~ok, float("-inf"))
            mx = torch.maximum(m, x.amax(-1))
            ms = torch.where(mx == float("-inf"), 0.0, mx * cexp)
            alpha = torch.exp2(m * cexp - ms)
            p = torch.exp2(x * cexp - ms[..., None])
            l = l * alpha + p.sum(-1)
            if pending is not None:
                acc = acc + pending[0] @ pending[1]
            acc = acc * alpha[..., None]
            m = mx
            pending = (p.to(torch.bfloat16).float(), vv[:, :, ks])
        if pending is not None:
            acc = acc + pending[0] @ pending[1]
        out[:, :, rows] = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)

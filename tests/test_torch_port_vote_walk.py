"""A plain-torch model of V1's three phases (smallhardface_tpu_torch/csrc/
vote.cu) on the CPU, held against the plain loop
(``ops/nms_device.greedy_steps``) and the JAX package's functions
(``smallhardface_tpu/ops/nms_jax.py``).

The model does what the kernel does, word for word:

- phase A: bit j of mask row i (i < j < n_valid) set when j would join
  i's cluster, by the IoU's float32 expression with i as the head; the
  words the kernel leaves unwritten (tiles below the diagonal, rows past
  n_valid) hold random bits here, as they may on the card;
- phase B: the remaining rows as 32-bit words, taken 32 rows at a time:
  the block's heads in order from each row's diagonal word alone (the
  lowest remaining row, then ``remaining & ~row``), then head by head the
  cluster in the later words ``remaining & row``; the records
  ``2 * head + merged`` of the merged clusters in order, and the last head
  when it is a single row; the cluster's words written over the head's
  row;
- phase C: a head's row copied, or a merged cluster summed in float32 as
  the earlier one-block kernel summed it (thread t of 512 takes members
  t + 512 k in ascending k, then a ``__shfl_down_sync`` tree in each warp
  and one over the 16 warps' partials), then the division.

Against the plain loop: the same clusters step by step, the same rows out,
the scores equal to the bit, the boxes within BOX_TOL of the largest
coordinate (the sums run in another order); on integer boxes with dyadic
scores every output equal to the bit. Against JAX: the rule of
tests/test_torch_port_vote.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from smallhardface_tpu.ops import nms_jax
from smallhardface_tpu_torch.ops import nms_device, vote_cases
from smallhardface_tpu_torch.ops.nms_device import _iou_with, greedy_steps
from smallhardface_tpu_torch.ops.vote_cases import EDGE_CASES, edge_case

BOX_TOL = 1e-6
# csrc/vote.cu's phase A tile (16 rows x 256 columns) and phase C block
MASK_ROWS, TILE_COLS, EMIT_THREADS = 16, 256, 512


def mask_words(dets, n_valid, thresh, vote, rng):
    """Phase A: (V, W) int64 words, random where the kernel writes none."""
    v = dets.shape[0]
    nw = (v + 31) // 32
    words = torch.from_numpy(rng.randint(0, 2 ** 32, (v, nw), np.int64))
    x1, y1, x2, y2, _ = dets.unbind(1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    iw = (torch.minimum(x2[:, None], x2[None]) - torch.maximum(
        x1[:, None], x1[None]) + 1).clamp_min(0)
    ih = (torch.minimum(y2[:, None], y2[None]) - torch.maximum(
        y1[:, None], y1[None]) + 1).clamp_min(0)
    inter = iw * ih
    iou = inter / (area[:, None] + area[None] - inter)
    member = (iou >= thresh) if vote else (iou > thresh)
    idx = torch.arange(v)
    member &= (idx[None] > idx[:, None]) & (idx[None] < n_valid)
    bits = torch.zeros(v, nw * 32, dtype=torch.int64)
    bits[:, :v] = member.to(torch.int64)
    computed = (bits.view(v, nw, 32) << torch.arange(32)).sum(2)
    # the kernel writes every word of a row below n_valid in a tile it
    # does not skip
    col0 = torch.arange(nw) * 32 // TILE_COLS * TILE_COLS
    row0 = idx // MASK_ROWS * MASK_ROWS
    written = ((idx < n_valid)[:, None] & (col0 < n_valid)[None]
               & (col0[None] + TILE_COLS - 1 > row0[:, None]))
    return torch.where(written, computed, words)


def walk(words, n_valid, vote):
    """Phase B, 32 rows at a time: (records, n_out, clusters); the clusters
    (one set of rows per head) are for the test, the kernel keeps only the
    words."""
    v, nw = words.shape
    rem = [0] * nw
    for w in range(nw):
        lo = 32 * w
        rem[w] = 0 if lo >= n_valid else (1 << min(32, n_valid - lo)) - 1
    recs, clusters = [], []
    last, last_merged = -1, False
    for blk in range((n_valid + 31) // 32):
        # the block's heads from the diagonal words (word blk of each row)
        cur, heads = rem[blk], []
        while cur:
            t = (cur & -cur).bit_length() - 1
            row_w = int(words[32 * blk + t, blk]) & 0xffffffff
            heads.append((t, cur & row_w))
            cur &= ~row_w & ~(1 << t) & 0xffffffff
        rem[blk] = 0
        # the words after blk, head by head in order
        for t, intra in heads:
            head = 32 * blk + t
            row = [int(x) & 0xffffffff for x in words[head]]
            cl = [0] * nw
            for w in range(blk + 1, nw):
                cl[w] = rem[w] & row[w]
                rem[w] &= ~row[w] & 0xffffffff
            merged = vote and (intra != 0 or any(cl))
            cl[blk] = intra | 1 << t
            words[head, blk:] = torch.tensor(cl[blk:])
            clusters.append({32 * w + i for w in range(nw) for i in range(32)
                             if cl[w] >> i & 1})
            if not vote or merged:
                recs.append(2 * head + int(merged))
            last, last_merged = head, merged
    if vote and last >= 0 and not last_merged:
        recs.append(2 * last)   # a single row when nothing remains after it
    return recs, len(recs), clusters


def _shfl_down_tree(lanes):
    """Lane 0's result of the warp's ``__shfl_down_sync`` tree over
    (s, sx1, sy1, sx2, sy2, max) x 32 lanes, in float32."""
    for off in (16, 8, 4, 2, 1):
        down = np.concatenate([lanes[:, off:], lanes[:, 32 - off:]], 1)
        lanes = np.concatenate([lanes[:5] + down[:5],
                                np.maximum(lanes[5:], down[5:])])
    return lanes[:, 0]


def _no_partial(n):
    lanes = np.zeros((6, n), np.float32)
    lanes[5] = -np.inf
    return lanes


def emit(dets, words, recs):
    """Phase C: the rows out (V, 5) float32, zeros after n_out. Thread t of
    EMIT_THREADS sums its members t + EMIT_THREADS k in ascending k, each
    warp reduces its lanes, and a last tree reduces the warps' partials
    (the lanes past them zero)."""
    d = dets.numpy()
    v, nw = words.shape
    out = np.zeros((v, 5), np.float32)
    for slot, code in enumerate(recs):
        head = code >> 1
        if not code & 1:
            out[slot] = d[head]
            continue
        threads = _no_partial(EMIT_THREADS)
        for w in range(head >> 5, nw):
            x = int(words[head, w])
            for t in range(32):
                if x >> t & 1:              # ascending j: ascending k
                    j = 32 * w + t
                    r, tid = d[j], j % EMIT_THREADS
                    sc = r[4]
                    threads[0, tid] = threads[0, tid] + sc
                    for f in range(4):
                        threads[1 + f, tid] = threads[1 + f, tid] + \
                            np.float32(r[f] * sc)
                    threads[5, tid] = max(threads[5, tid], sc)
        warps = _no_partial(32)
        for q in range(EMIT_THREADS // 32):
            warps[:, q] = _shfl_down_tree(threads[:, 32 * q:32 * q + 32])
        s = _shfl_down_tree(warps)
        out[slot] = [s[1] / s[0], s[2] / s[0], s[3] / s[0], s[4] / s[0],
                     s[5]]
    return out


def model(dets, n_valid, thresh, vote, seed=0):
    """(out, n_out, clusters) of V1's three phases on one image."""
    thresh = torch.tensor(thresh, dtype=torch.float32)
    words = mask_words(dets, n_valid, thresh, vote,
                       np.random.RandomState(seed))
    recs, n_out, clusters = walk(words, n_valid, vote)
    return torch.from_numpy(emit(dets, words, recs)), n_out, clusters


def plain_clusters(dets, n_valid, thresh, vote):
    """Each step's members by the plain loop's own expression."""
    v = dets.shape[0]
    x1, y1, x2, y2, _ = dets.unbind(1)
    area = (x2 - x1 + 1) * (y2 - y1 + 1)
    idx = torch.arange(v)
    remaining = idx < n_valid
    thresh = torch.tensor(thresh, dtype=torch.float32)
    clusters = []
    while bool(remaining.any()):
        i = int(torch.argmax(remaining.to(torch.uint8)))
        iou = _iou_with(x1, y1, x2, y2, area, i)
        member = (iou >= thresh) if vote else (iou > thresh)
        cluster = remaining & (member | (idx == i))
        remaining &= ~cluster
        clusters.append(set(torch.nonzero(cluster)[:, 0].tolist()))
    return clusters


@pytest.mark.parametrize("vote", [True, False], ids=["BBOX_VOTE", "NMS"])
@pytest.mark.parametrize("name", EDGE_CASES)
def test_walk_model_matches_plain_loop(name, vote):
    dets, n, thresh, integer = edge_case(name)
    t = torch.from_numpy(dets)
    got, n_got, clusters = model(t, n, thresh, vote)
    want, n_want, steps, _ = greedy_steps(t, n, thresh, vote)
    assert clusters == plain_clusters(t, n, thresh, vote)
    assert len(clusters) == steps
    assert n_got == int(n_want)
    assert not got[n_got:].any()
    assert torch.equal(got[:, 4], want[:, 4])
    if integer:
        assert torch.equal(got, want)
    else:
        peak = float(t[:n, :4].abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=BOX_TOL * peak)


def test_walk_cases_pin_the_rules():
    """What the cases are for: the threshold pairs merge in the vote (>=)
    and stay apart in NMS (>); the chain is V singleton steps; one cluster
    takes every row; a zero-area head is taken into its own cluster."""
    def n_out(name, vote):
        dets, n, thresh, _ = edge_case(name)
        return model(torch.from_numpy(dets), n, thresh, vote)[1]
    assert [n_out(c, v) for c, v in (
        ("at_threshold", True), ("at_threshold", False), ("no_overlap", True),
        ("no_overlap", False), ("one_cluster", True))] == [3, 6, 1, 130, 1]
    dets = torch.from_numpy(vote_cases.degenerate_dets())
    _, _, clusters = model(dets, 8, 0.4, True)
    assert clusters[0] == {0} and len(clusters) == 6


def test_walk_survives_unwritten_words():
    """Two seeds of the random words phase A leaves unwritten give the
    same result: the walk reads none of them."""
    dets, n, thresh, _ = edge_case("v1100_two_tiles")
    t = torch.from_numpy(dets)
    a = model(t, n, thresh, True, seed=1)
    b = model(t, n, thresh, True, seed=2)
    assert torch.equal(a[0], b[0]) and a[1:] == b[1:]


def test_walk_model_batch_with_unequal_n_valid():
    """Each image of a batch voted alone, as one call of V1 does: the
    model per image against the plain loop over the batch."""
    rng = np.random.RandomState(3)
    dets = np.stack([vote_cases.crowd_dets(rng, 96, centres=c)
                     for c in (4, 20, 9)])
    n_valid = [96, 37, 0]
    for i, n in enumerate(n_valid):
        dets[i, n:, 4] = -np.inf
    t = torch.from_numpy(dets)
    want, n_want = nms_device.bbox_vote_device_reference(
        t, torch.tensor(n_valid, dtype=torch.int32), 0.4)
    for i, n in enumerate(n_valid):
        got, n_got, _ = model(t[i], n, 0.4, True)
        assert n_got == int(n_want[i])
        assert torch.equal(got[:, 4], want[i, :, 4])
        torch.testing.assert_close(got, want[i], rtol=0,
                                   atol=BOX_TOL * 1000)


@pytest.mark.parametrize("method", ["BBOX_VOTE", "NMS"])
@pytest.mark.parametrize("name", ["v45_integer", "v100_floats", "n_valid_1",
                                  "one_cluster", "no_overlap",
                                  "at_threshold"])
def test_walk_model_matches_jax(name, method):
    dets, n, thresh, _ = edge_case(name)
    vote = method == "BBOX_VOTE"
    got, n_got, _ = model(torch.from_numpy(dets), n, thresh, vote)
    got = got.numpy()[:n_got]
    if vote:
        out, cnt = nms_jax.bbox_vote_device(jnp.asarray(dets), n,
                                            np.float32(thresh))
        want = np.asarray(out)[:int(cnt)]
    else:
        idx, _, n_keep = nms_jax.nms_device(
            jnp.asarray(dets[:, :4]), jnp.asarray(dets[:, 4]),
            np.float32(thresh), n_valid=n)
        want = dets[np.asarray(idx)[:int(n_keep)]]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 4], want[:, 4])
    peak = max(float(np.abs(dets[:n, :4]).max(initial=1.0)), 1.0)
    np.testing.assert_allclose(got[:, :4], want[:, :4], rtol=0,
                               atol=BOX_TOL * peak)

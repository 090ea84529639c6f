"""Binary bag-of-words: vocabulary tree as arrays, batched quantization,
shared-word place-recognition scoring.

Replaces the vendored DBoW2 (``Thirdparty/DBoW2``: TemplatedVocabulary k-ary
tree over 256-bit ORB descriptors + BowVector/FeatureVector + the
KeyFrameDatabase inverted index, ``KeyFrameDatabase.cc``). Batched re-design:

- The vocabulary is two arrays: node descriptors ``[n_nodes, 8]`` uint32 and
  a children table ``[n_nodes, k]``; quantization descends all features in
  lock-step (gather children -> popcount -> argmin), L levels deep — one
  fused kernel for a whole frame instead of per-descriptor tree walks.
- Instead of an inverted index (word -> KF list, a pointer structure), each
  keyframe keeps its sorted word-id list ``[F]``; shared-word counts against
  a query are a batched two-pointer intersection via ``searchsorted`` over
  all keyframes at once — the dense equivalent of
  ``DetectRelocalizationCandidates``'s word-sharing pass.
- Supports both a compact self-trained vocabulary (hierarchical binary
  k-medians, for offline/synthetic use) and loading ORB-SLAM's ORBvoc.txt
  (``TemplatedVocabulary::loadFromTextFile`` format) for parity with
  existing deployments.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp


class Vocabulary(NamedTuple):
    node_desc: jax.Array   # [n_nodes, 8] uint32
    children: jax.Array    # [n_nodes, k] int32 (-1 = none)
    is_leaf: jax.Array     # [n_nodes] bool
    word_id: jax.Array     # [n_nodes] int32 (leaf enumeration, -1 internal)
    weight: jax.Array      # [n_nodes] f32 idf weight of leaves
    k: int
    depth: int
    n_words: int


# ---------------------------------------------------------------------------
# Quantization
# ---------------------------------------------------------------------------

def _hamming(a, b):
    return jnp.sum(
        jax.lax.population_count(jnp.bitwise_xor(a, b)), axis=-1
    ).astype(jnp.int32)


@partial(jax.jit, static_argnames=("depth",))
def quantize(voc: Vocabulary, desc: jax.Array, valid: jax.Array, depth: int):
    """Descriptors [F, 8] -> (word ids [F], weights [F]); invalid -> -1."""
    F = desc.shape[0]
    node = jnp.zeros(F, jnp.int32)
    for _ in range(depth):
        ch = voc.children[node]                        # [F, k]
        ch_ok = ch >= 0
        ch_desc = voc.node_desc[jnp.clip(ch, 0, None)]  # [F, k, 8]
        d = _hamming(ch_desc, desc[:, None, :])
        d = jnp.where(ch_ok, d, 1 << 20)
        best = jnp.argmin(d, axis=-1)
        nxt = jnp.take_along_axis(ch, best[:, None], axis=1)[:, 0]
        # stop at leaves (stay put when no children)
        node = jnp.where(jnp.any(ch_ok, axis=-1), nxt, node)
    words = jnp.where(valid, voc.word_id[node], -1)
    weights = jnp.where(valid, voc.weight[node], 0.0)
    return words, weights


# ---------------------------------------------------------------------------
# Place-recognition scoring
# ---------------------------------------------------------------------------

def word_idf(voc: Vocabulary) -> jax.Array:
    """[n_words] idf weight per WORD id (leaf enumeration) — the per-node
    weights re-indexed by word id, for weighting shared-word scores the way
    DBoW2's tf-idf scoring does (TemplatedVocabulary::setNodeWeights)."""
    wid = jnp.clip(voc.word_id, 0, max(voc.n_words - 1, 0))
    out = jnp.zeros((max(voc.n_words, 1),), jnp.float32)
    return out.at[jnp.where(voc.is_leaf, wid, voc.n_words - 1)].max(
        jnp.where(voc.is_leaf, voc.weight, 0.0), mode="drop"
    )


@jax.jit
def shared_word_scores(
    query_words: jax.Array,     # [F] sorted word ids (-1 pad at front ok)
    query_weights: jax.Array,   # [F]
    kf_words: jax.Array,        # [K, F] per-KF sorted word ids
    kf_valid: jax.Array,        # [K]
) -> tuple[jax.Array, jax.Array]:
    """(shared word counts [K], idf-weighted scores [K]).

    Batched equivalent of the inverted-index accumulation in
    ``KeyFrameDatabase::DetectRelocalizationCandidates`` (KeyFrameDatabase.cc:742).
    """
    qw = jnp.sort(query_words)
    order = jnp.argsort(query_words)
    qweights = query_weights[order]
    # for each KF word, is it present in the query?
    pos = jnp.searchsorted(qw, kf_words)             # [K, F]
    pos = jnp.clip(pos, 0, qw.shape[0] - 1)
    hit = (qw[pos] == kf_words) & (kf_words >= 0)
    counts = jnp.sum(hit, axis=-1)
    scores = jnp.sum(jnp.where(hit, qweights[pos], 0.0), axis=-1)
    counts = jnp.where(kf_valid, counts, 0)
    scores = jnp.where(kf_valid, scores, 0.0)
    return counts, scores


def reloc_candidates(counts, scores, n: int, min_common_ratio: float = 0.8):
    """Top-n candidate KFs after the reference's shared-word gate:
    keep KFs with counts >= 0.8 * max_count, rank by score."""
    max_c = jnp.max(counts)
    ok = counts >= (min_common_ratio * max_c).astype(counts.dtype)
    ranked = jnp.where(ok, scores, -1.0)
    vals, idx = jax.lax.top_k(ranked, n)
    return jnp.where(vals > 0, idx, -1), vals


# ---------------------------------------------------------------------------
# Vocabulary training (hierarchical binary k-medians)
# ---------------------------------------------------------------------------

def _np_hamming(a, b):
    return np.unpackbits(
        np.bitwise_xor(a[:, None, :], b[None, :, :]).view(np.uint8), axis=-1
    ).sum(-1)


def _bit_majority(descs: np.ndarray) -> np.ndarray:
    """Median (bit-majority) of binary descriptors [N, 8]u32 -> [8]u32."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [N, 256]
    maj = (bits.sum(0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def train_vocabulary(descs: np.ndarray, k: int = 8, depth: int = 4,
                     seed: int = 0, iters: int = 6) -> Vocabulary:
    """Hierarchical binary k-medians over descriptors [N, 8] uint32
    (TemplatedVocabulary::create's HKmeansStep, numpy offline path)."""
    rng = np.random.default_rng(seed)
    nodes_desc = [np.zeros(8, np.uint32)]
    children = [[]]
    levels = [[0]]  # node ids at current level
    assignments = {0: np.arange(len(descs))}

    for lvl in range(depth):
        next_level = []
        for nid in levels[-1]:
            idx = assignments.pop(nid)
            if len(idx) == 0:
                continue
            kk = min(k, len(idx))
            # k-medians init: random distinct samples
            centers = descs[rng.choice(idx, kk, replace=False)]
            for _ in range(iters):
                d = _np_hamming(descs[idx], centers)
                lab = d.argmin(1)
                centers = np.stack([
                    _bit_majority(descs[idx[lab == j]]) if np.any(lab == j)
                    else centers[j]
                    for j in range(kk)
                ])
            d = _np_hamming(descs[idx], centers)
            lab = d.argmin(1)
            ch_ids = []
            for j in range(kk):
                cid = len(nodes_desc)
                nodes_desc.append(centers[j])
                children.append([])
                ch_ids.append(cid)
                assignments[cid] = idx[lab == j]
            children[nid] = ch_ids
            next_level.extend(ch_ids)
        levels.append(next_level)

    n_nodes = len(nodes_desc)
    child_tab = np.full((n_nodes, k), -1, np.int32)
    for nid, ch in enumerate(children):
        child_tab[nid, : len(ch)] = ch
    is_leaf = np.array([len(c) == 0 for c in children])
    word_id = np.full(n_nodes, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves))

    # idf weights from the training distribution
    weight = np.zeros(n_nodes, np.float32)
    n_total = max(len(descs), 1)
    for nid in leaves:
        n_in = len(assignments.get(nid, []))
        weight[nid] = np.log(n_total / max(n_in, 1))

    return Vocabulary(
        node_desc=jnp.asarray(np.stack(nodes_desc)),
        children=jnp.asarray(child_tab),
        is_leaf=jnp.asarray(is_leaf),
        word_id=jnp.asarray(word_id),
        weight=jnp.asarray(weight),
        k=k, depth=depth, n_words=len(leaves),
    )


# ---------------------------------------------------------------------------
# ORBvoc.txt loader (DBoW2 text format)
# ---------------------------------------------------------------------------

def load_orbvoc_txt(path: str) -> Vocabulary:
    """Load ORB-SLAM's vocabulary (TemplatedVocabulary.h:1350 text format):
    header 'k L scoring weighting', then one line per node:
    'parent_id is_leaf d0 ... d31 weight'."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents, leaf_flags, descs, weights = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            leaf_flags.append(int(parts[1]) != 0)
            descs.append(np.array([int(x) for x in parts[2:34]], np.uint8))
            weights.append(float(parts[34]))
    n = len(parents) + 1  # +1 root
    node_desc = np.zeros((n, 8), np.uint32)
    node_desc[1:] = np.stack(descs).view(np.uint32)
    child_tab = np.full((n, k), -1, np.int32)
    counts = np.zeros(n, np.int32)
    for i, p in enumerate(parents):
        nid = i + 1
        if counts[p] < k:
            child_tab[p, counts[p]] = nid
            counts[p] += 1
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = np.array(leaf_flags)
    word_id = np.full(n, -1, np.int32)
    leaves = np.nonzero(is_leaf)[0]
    word_id[leaves] = np.arange(len(leaves))
    weight = np.zeros(n, np.float32)
    weight[1:] = np.array(weights, np.float32)
    return Vocabulary(
        node_desc=jnp.asarray(node_desc),
        children=jnp.asarray(child_tab),
        is_leaf=jnp.asarray(is_leaf),
        word_id=jnp.asarray(word_id),
        weight=jnp.asarray(weight),
        k=k, depth=L, n_words=len(leaves),
    )

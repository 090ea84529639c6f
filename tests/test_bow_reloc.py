"""BoW vocabulary, place-recognition scoring, PnP RANSAC, relocalization."""

import numpy as np
import jax
import jax.numpy as jnp

from tc2li_slam_tpu.geom import camera, lie
from tc2li_slam_tpu.ops import bow, orb
from tc2li_slam_tpu.solver import pnp

CAM = camera.Pinhole.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=250.0)


def rand_desc(rng, n):
    return rng.integers(0, 2**32, size=(n, 8), dtype=np.uint32)


def test_vocabulary_train_and_quantize(rng):
    descs = rand_desc(rng, 2000)
    voc = bow.train_vocabulary(descs, k=4, depth=3, seed=0)
    assert voc.n_words > 16
    words, weights = bow.quantize(
        voc, jnp.asarray(descs[:256]), jnp.ones(256, bool), voc.depth
    )
    w = np.asarray(words)
    assert (w >= 0).all() and (w < voc.n_words).all()
    # same descriptor -> same word, deterministic
    words2, _ = bow.quantize(
        voc, jnp.asarray(descs[:256]), jnp.ones(256, bool), voc.depth
    )
    np.testing.assert_array_equal(w, np.asarray(words2))
    # invalid -> -1
    words3, _ = bow.quantize(
        voc, jnp.asarray(descs[:4]), jnp.zeros(4, bool), voc.depth
    )
    assert (np.asarray(words3) == -1).all()


def test_quantize_nearest_structure(rng):
    """A descriptor equal to a leaf's centroid quantizes into a word whose
    path is consistent (just sanity: perturbing few bits keeps the word)."""
    descs = rand_desc(rng, 1000)
    voc = bow.train_vocabulary(descs, k=4, depth=3, seed=1)
    d0 = descs[:64]
    w0 = np.asarray(bow.quantize(voc, jnp.asarray(d0), jnp.ones(64, bool), voc.depth)[0])
    d1 = d0 ^ np.uint32(1)  # flip one bit
    w1 = np.asarray(bow.quantize(voc, jnp.asarray(d1), jnp.ones(64, bool), voc.depth)[0])
    assert (w0 == w1).mean() > 0.7


def test_shared_word_scores(rng):
    descs = rand_desc(rng, 3000)
    voc = bow.train_vocabulary(descs, k=4, depth=3, seed=0)
    F = 128
    frameA = descs[:F]
    frameB = np.concatenate([descs[:F // 2], rand_desc(rng, F // 2)])  # half shared
    frameC = rand_desc(rng, F)

    def words(d):
        w, wt = bow.quantize(voc, jnp.asarray(d), jnp.ones(F, bool), voc.depth)
        return jnp.sort(w), wt

    wA, wtA = words(frameA)
    kf_words = jnp.stack([words(frameA)[0], words(frameB)[0], words(frameC)[0]])
    counts, scores = bow.shared_word_scores(
        wA, wtA, kf_words, jnp.ones(3, bool)
    )
    c = np.asarray(counts)
    assert c[0] >= c[1] >= 20
    assert c[0] > c[2]
    cand, vals = bow.reloc_candidates(counts, scores, 2)
    assert int(np.asarray(cand)[0]) == 0


def test_pnp_ransac_with_outliers(rng):
    N = 120
    X = np.stack([rng.uniform(-10, 10, N), rng.uniform(-6, 6, N),
                  rng.uniform(5, 30, N)], -1).astype(np.float32)
    T_gt = np.asarray(lie.se3_exp(jnp.asarray(
        rng.uniform(-0.3, 0.3, 6).astype(np.float32))))
    Xc = (T_gt[:3, :3] @ X.T).T + T_gt[:3, 3]
    uv = np.array(camera.project(CAM, jnp.asarray(Xc)))
    uv += rng.normal(0, 0.5, uv.shape)
    uv[:30] += rng.uniform(30, 120, (30, 2))  # 25% outliers
    res = pnp.pnp_ransac(
        CAM, jnp.asarray(X), jnp.asarray(uv, jnp.float32), jnp.ones(N, bool),
        jax.random.PRNGKey(0), n_hyp=128,
    )
    assert bool(res.ok)
    err = np.asarray(lie.se3_log(jnp.asarray(np.linalg.inv(T_gt)) @ res.T_cw))
    assert np.abs(err).max() < 1e-2, f"pnp err {err}"
    inl = np.asarray(res.inliers)
    assert inl[:30].mean() < 0.2 and inl[30:].mean() > 0.9


def test_pnp_fails_gracefully_on_garbage(rng):
    N = 50
    X = rng.normal(0, 10, (N, 3)).astype(np.float32)
    uv = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    res = pnp.pnp_ransac(
        CAM, jnp.asarray(X), jnp.asarray(uv), jnp.ones(N, bool),
        jax.random.PRNGKey(1), n_hyp=64,
    )
    assert np.isfinite(np.asarray(res.T_cw)).all()


def test_orbvoc_txt_roundtrip(tmp_path, rng):
    """Write a tiny vocabulary in ORBvoc.txt format and load it."""
    k, L = 2, 2
    lines = [f"{k} {L} 0 0"]
    # 2 root children (internal), each with 2 leaf children
    descs = rand_desc(rng, 6)
    parent_of = [0, 0, 1, 1, 2, 2]
    is_leaf = [0, 0, 1, 1, 1, 1]
    for i in range(6):
        d = descs[i].view(np.uint8)
        lines.append(
            f"{parent_of[i]} {is_leaf[i]} " + " ".join(str(b) for b in d)
            + " 0.5"
        )
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    voc = bow.load_orbvoc_txt(str(path))
    assert voc.n_words == 4
    assert voc.k == 2 and voc.depth == 2
    # quantization runs and lands on a leaf word
    w, _ = bow.quantize(voc, jnp.asarray(descs[2:3]), jnp.ones(1, bool), voc.depth)
    assert 0 <= int(w[0]) < 4


def _gen_dbow2_text(rng, k=4, L=3, p_prune=0.25, p_early_leaf=0.15):
    """Random vocabulary in DBoW2's text format (TemplatedVocabulary.h:1350
    save/load layout): BFS node order (parents precede children), irregular
    branching (pruned children, leaves above the bottom level) exactly like
    a real trained ORBvoc. Returns (lines, parsed-node table)."""
    lines = [f"{k} {L} 0 0"]   # header: k L scoring weighting
    nodes = [dict(parent=-1, leaf=False, desc=None, w=0.0, children=[])]
    frontier = [(0, 0)]        # (node id, level)
    while frontier:
        pid, lvl = frontier.pop(0)
        n_ch = int(rng.integers(2, k + 1)) if rng.random() > p_prune else \
            int(rng.integers(1, max(k - 1, 2)))
        for _ in range(n_ch):
            nid = len(nodes)
            leaf = (lvl + 1 == L) or (rng.random() < p_early_leaf)
            d = rng.integers(0, 256, 32, dtype=np.uint8)
            w = float(rng.random()) if leaf else 0.0
            nodes.append(dict(parent=pid, leaf=leaf, desc=d, w=w,
                              children=[]))
            nodes[pid]["children"].append(nid)
            lines.append(
                f"{pid} {int(leaf)} " + " ".join(str(b) for b in d)
                + f" {w}")
            if not leaf:
                frontier.append((nid, lvl + 1))
    return lines, nodes


def _dbow2_transform(nodes, desc_u8):
    """NumPy oracle of TemplatedVocabulary::transform (TemplatedVocabulary.
    h:1230-1271): descend from the root, at each level pick the child with
    the minimum Hamming distance (strict less — FIRST minimum wins), stop
    at a leaf; word ids = leaf enumeration in file order."""
    wid = 0
    word_ids = {}
    for i, n in enumerate(nodes):
        if n["leaf"]:
            word_ids[i] = wid
            wid += 1
    nid = 0
    while not nodes[nid]["leaf"]:
        best_d, best = None, None
        for c in nodes[nid]["children"]:
            d = int(np.unpackbits(
                np.bitwise_xor(nodes[c]["desc"], desc_u8)).sum())
            if best_d is None or d < best_d:
                best_d, best = d, c
        nid = best
    return word_ids[nid], nodes[nid]["w"]


def test_orbvoc_loader_parity_with_dbow2(tmp_path, rng):
    """Word-id agreement of load_orbvoc_txt +
    quantize with the DBoW2 text format and transform semantics, on an
    irregular (real-vocabulary-shaped) random tree including exact-node and
    tie-inducing queries."""
    lines, nodes = _gen_dbow2_text(rng, k=4, L=3)
    path = tmp_path / "voc.txt"
    path.write_text("\n".join(lines) + "\n")
    voc = bow.load_orbvoc_txt(str(path))
    n_leaves = sum(1 for n in nodes if n["leaf"])
    assert voc.n_words == n_leaves

    # queries: random descriptors + exact node descriptors (guaranteed
    # 0-distance hits) + duplicated descriptors across sibling nodes (ties)
    qs = [rng.integers(0, 256, 32, dtype=np.uint8) for _ in range(256)]
    qs += [n["desc"] for n in nodes[1:min(len(nodes), 40)]]
    # force ties: query equidistant between two siblings
    for i in range(0, min(len(nodes) - 3, 30), 2):
        a, b = nodes[1 + i]["desc"], nodes[2 + i]["desc"]
        half = a.copy()
        diff_bits = np.unpackbits(np.bitwise_xor(a, b))
        idx = np.nonzero(diff_bits)[0]
        for j in idx[: len(idx) // 2]:
            half[j // 8] ^= np.uint8(1 << (7 - (j % 8)))
        qs.append(half)
    Q = np.stack(qs)

    want = np.array([_dbow2_transform(nodes, q)[0] for q in Q])
    got, wgt = bow.quantize(
        voc, jnp.asarray(Q.view(np.uint32)), jnp.ones(len(Q), bool),
        voc.depth,
    )
    got = np.asarray(got)
    assert (got == want).all(), (
        f"word-id mismatch on {np.sum(got != want)}/{len(Q)} queries"
    )
    # weights of the landed words agree with the file
    want_w = np.array([_dbow2_transform(nodes, q)[1] for q in Q], np.float32)
    assert np.allclose(np.asarray(wgt), want_w, atol=1e-6)


def test_retrieval_quality_at_vocabulary_scale(rng):
    """Retrieval QUALITY at real-vocabulary branching
    (k=10, the ORBvoc shape — depth reduced to keep the CPU test fast): a
    noisy re-observation of a place must rank that place top-1 by
    idf-weighted shared-word score among 40 distinct places, and the
    candidate gate must keep it. Covers quantize -> shared_word_scores ->
    reloc_candidates end to end the way loop/reloc detection uses them
    (KeyFrameDatabase::DetectRelocalizationCandidates semantics)."""
    n_places, F = 40, 128
    base = rand_desc(rng, n_places * F)
    voc = bow.train_vocabulary(base[:8000], k=10, depth=4, seed=0)
    assert voc.n_words > 2000  # real branching factor, thousands of words

    def words_sorted(d):
        w, wt = bow.quantize(voc, jnp.asarray(d), jnp.ones(len(d), bool),
                             voc.depth)
        order = jnp.argsort(w)
        return w[order], wt[order]

    kf_words = jnp.stack([
        words_sorted(base[p * F:(p + 1) * F])[0] for p in range(n_places)
    ])

    hits = 0
    for target in (3, 17, 31):
        # re-observation: each descriptor perturbed by ~8 of 256 bits
        d = base[target * F:(target + 1) * F].copy()
        for _ in range(8):
            word = rng.integers(0, 8, F)
            bit = rng.integers(0, 32, F).astype(np.uint32)
            d[np.arange(F), word] ^= (np.uint32(1) << bit)
        qw, qwt = words_sorted(d)
        counts, scores = bow.shared_word_scores(
            qw, qwt, kf_words, jnp.ones(n_places, bool))
        if int(jnp.argmax(scores)) == target:
            hits += 1
        cand, _ = bow.reloc_candidates(counts, scores, 3)
        assert target in np.asarray(cand), (
            f"place {target} not in candidate set {np.asarray(cand)}")
    assert hits == 3, f"top-1 retrieval failed ({hits}/3)"

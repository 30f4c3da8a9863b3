"""Keyframe database: place-recognition queries as gather + row-reduce.

Replaces the reference KeyFrameDatabase inverted file
(src/KeyFrameDatabase.cc, include/KeyFrameDatabase.h:89 word->KF lists).
Storage is SPARSE per keyframe — the word id of each feature plus the
row's tf-idf norm — not a dense (max_kf, n_words) matrix: a keyframe
touches at most n_feat of the n_words vocabulary words, so the dense
design paid O(n_words) memory AND compute per row, which is what capped
the round-4 build at a 10k-word vocabulary (the reference ships k=10
L=6 ~ 1M words, src/ClientSystem.cc:69-77). Here database memory is
O(max_kf * n_feat) regardless of vocabulary size, and a query is:

    score_k = sum_f q[word(k, f)] * idf[word(k, f)] / norm_k

one (max_kf, n_feat) gather from the query's dense tf-idf vector + a
row reduction — identical cosine scores to the dense formulation
(tf_w copies of idf_w * q_w sum to v_w * q_w), fixed-shape, and
the only n_words-sized array alive is the single query vector.

Shared across all agents on the server (one instance, rows tagged by
agent) — exactly the design that enables inter-agent loop detection
(ServerSystem.cc:49-63).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from multi_orbslam3_jax.bow.vocabulary import Vocabulary, assign_words, bow_vector


class KeyframeDatabase(NamedTuple):
    word: jnp.ndarray     # (max_kf, n_feat) int32 word id per feature (-1 pad)
    norm: jnp.ndarray     # (max_kf,) float32 ||tf-idf row|| (1 where empty)
    active: jnp.ndarray   # (max_kf,) bool
    agent: jnp.ndarray    # (max_kf,) int32 owning agent of each row

    @classmethod
    def empty(cls, max_kf: int, n_words: int = 0,
              n_feat: int = 0) -> "KeyframeDatabase":
        """n_words is accepted for call-site compatibility but unused —
        storage no longer depends on vocabulary size. n_feat may be 0:
        the word table is sized lazily on the first insert."""
        return cls(word=jnp.full((max_kf, max(n_feat, 0)), -1, jnp.int32),
                   norm=jnp.ones((max_kf,), jnp.float32),
                   active=jnp.zeros((max_kf,), bool),
                   agent=jnp.zeros((max_kf,), jnp.int32))


def _ensure_width(db: KeyframeDatabase, n_feat: int) -> KeyframeDatabase:
    if db.word.shape[1] == n_feat:
        return db
    max_kf = db.word.shape[0]
    word = jnp.full((max_kf, n_feat), -1, jnp.int32)
    if db.word.shape[1] > 0:
        w = min(n_feat, db.word.shape[1])
        word = word.at[:, :w].set(db.word[:, :w])
    return db._replace(word=word)


@jax.jit
def _row_norm(voc: Vocabulary, words: jnp.ndarray) -> jnp.ndarray:
    """||tf-idf vector|| of one keyframe's word list."""
    ok = words >= 0
    w = jnp.where(ok, words, 0)
    tf = jnp.zeros((voc.n_words,), jnp.float32).at[w].add(
        ok.astype(jnp.float32))
    v = tf * voc.idf
    return jnp.linalg.norm(v) + 1e-8


@jax.jit
def _add_row(db: KeyframeDatabase, voc: Vocabulary, slot,
             desc: jnp.ndarray, valid: jnp.ndarray, agent):
    words = assign_words(voc, desc, valid)
    return KeyframeDatabase(
        word=db.word.at[slot].set(words),
        norm=db.norm.at[slot].set(_row_norm(voc, words)),
        active=db.active.at[slot].set(True),
        agent=db.agent.at[slot].set(jnp.int32(agent))), words


def add_keyframe_bow(db: KeyframeDatabase, voc: Vocabulary, slot,
                     desc: jnp.ndarray, valid: jnp.ndarray,
                     agent=0):
    """Insert/overwrite row `slot` with the word list of a KF's
    descriptors. Returns (db, words (N,)) — words are reused for
    feature-level matching."""
    db = _ensure_width(db, desc.shape[0])
    return _add_row(db, voc, slot, desc, valid, agent)


@jax.jit
def _add_rows(db: KeyframeDatabase, voc: Vocabulary, slots: jnp.ndarray,
              desc: jnp.ndarray, valid: jnp.ndarray,
              agents: jnp.ndarray) -> KeyframeDatabase:
    max_kf = db.word.shape[0]
    words = jax.vmap(lambda d, m: assign_words(voc, d, m))(desc, valid)
    norms = jax.vmap(lambda w: _row_norm(voc, w))(words)
    ok = slots >= 0
    safe = jnp.where(ok, slots, max_kf)

    def scat(arr, vals):
        ext = jnp.concatenate([arr, jnp.zeros_like(arr[:1])], 0)
        return ext.at[safe].set(vals.astype(arr.dtype))[:max_kf]

    return KeyframeDatabase(
        word=scat(db.word, words),
        norm=scat(db.norm, norms),
        active=scat(db.active, ok),
        agent=scat(db.agent, agents))


def add_keyframes_bow_batch(db: KeyframeDatabase, voc: Vocabulary,
                            slots: jnp.ndarray, desc: jnp.ndarray,
                            valid: jnp.ndarray, agents: jnp.ndarray
                            ) -> KeyframeDatabase:
    """Batched row insert: slots (B,) with -1 for padding rows (routed to
    a sacrificial scatter slot); desc (B, N, 8); valid (B, N). One vmapped
    tree descent + one scatter per server comm cycle instead of per-KF
    dispatches."""
    db = _ensure_width(db, desc.shape[1])
    return _add_rows(db, voc, slots, desc, valid, agents)


@jax.jit
def erase_keyframe_bow(db: KeyframeDatabase, slot) -> KeyframeDatabase:
    return db._replace(word=db.word.at[slot].set(-1),
                       norm=db.norm.at[slot].set(1.0),
                       active=db.active.at[slot].set(False))


@jax.jit
def _score_rows(db: KeyframeDatabase, voc: Vocabulary,
                q: jnp.ndarray, exclude: jnp.ndarray) -> jnp.ndarray:
    ok = db.word >= 0
    w = jnp.where(ok, db.word, 0)
    contrib = jnp.where(ok, q[w] * voc.idf[w], 0.0)
    scores = jnp.sum(contrib, axis=1) / db.norm
    return jnp.where(db.active & ~exclude, scores, 0.0)


@jax.jit
def query(db: KeyframeDatabase, voc: Vocabulary, desc: jnp.ndarray,
          valid: jnp.ndarray, exclude: jnp.ndarray) -> jnp.ndarray:
    """Score every database row against a frame's descriptors.

    exclude: (max_kf,) bool — rows to suppress (the query KF's covisible
    neighborhood, reference DetectNBestCandidates connected-KF exclusion).
    Returns (max_kf,) float32 cosine similarities (0 where inactive).
    """
    words = assign_words(voc, desc, valid)
    q = bow_vector(voc, words)
    return _score_rows(db, voc, q, exclude)


@jax.jit
def query_vector(db: KeyframeDatabase, voc: Vocabulary, v: jnp.ndarray,
                 exclude: jnp.ndarray) -> jnp.ndarray:
    """Same as `query` but with a precomputed dense tf-idf vector."""
    return _score_rows(db, voc, v, exclude)

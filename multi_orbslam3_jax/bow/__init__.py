"""Bag-of-words place recognition.

Replaces DBoW2's TemplatedVocabulary + the reference KeyFrameDatabase
(Thirdparty/DBoW2, src/KeyFrameDatabase.cc): the vocabulary tree is
flattened into device arrays and descriptor->word assignment is a
level-by-level batched Hamming argmin; the inverted-file + L1 scoring
becomes a dense tf-idf matrix whose queries are a single matvec. The
database is shared across agents on the server — the property
that makes inter-agent loop detection work (SURVEY.md §1).
"""

from multi_orbslam3_jax.bow.vocabulary import Vocabulary, train_vocabulary  # noqa: F401
from multi_orbslam3_jax.bow.database import KeyframeDatabase  # noqa: F401

"""hpfw_jax — audio fingerprinting / live song identification on GPUs.

A from-scratch JAX/XLA rebuild of the capabilities of the C++ reference
library kisasexypantera94/hpfw (see SURVEY.md): CQT spectrogram -> learned
spectro-temporal projection -> sign-binarized 64-bit hashprints, PCA filter
learning, and XOR+popcount Hamming matching against a fingerprint database
sharded across a device mesh.

Public surface (mirrors the reference, SURVEY.md §1.2):
    fingerprint(audio)    -> hashprint sequence
    match(query, db)      -> ranked track IDs
    build_db / learn_filters / FingerprintDB.save/load
    streaming.StreamingSession for live song ID
    streaming.StreamingPool for batched concurrent live streams
    artist.ArtistDB for per-artist filter banks (known-artist song ID)
"""

from .utils.cache import enable_compilation_cache as _enable_cache

_enable_cache()

from .api import (FingerprintDB, build_db, fingerprint, fingerprint_multi,
                  learn_filters, match)
from .artist import ArtistDB
from .config import DEFAULT_CONFIG, HpfwConfig

__version__ = "0.2.0"

__all__ = [
    "FingerprintDB", "build_db", "fingerprint", "fingerprint_multi",
    "learn_filters", "match", "ArtistDB",
    "HpfwConfig", "DEFAULT_CONFIG", "__version__",
]

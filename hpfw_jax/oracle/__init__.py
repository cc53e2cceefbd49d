from .pipeline import (
    assert_bits_match_with_margin_audit,
    binarize,
    context_windows,
    cqt,
    cqt_kernel_matrix,
    delta_margins,
    deltas,
    features,
    fingerprint,
    fix_eigenvector_signs,
    frame_signal,
    hamming_similarity,
    learn_filters,
    match,
    match_track,
    pack_bits,
    packed_to_uint64,
    uint64_to_packed,
)

__all__ = [
    "assert_bits_match_with_margin_audit", "binarize", "context_windows", "cqt", "cqt_kernel_matrix",
    "delta_margins", "deltas", "features", "fingerprint",
    "fix_eigenvector_signs", "frame_signal", "hamming_similarity",
    "learn_filters", "match", "match_track", "pack_bits",
    "packed_to_uint64", "uint64_to_packed",
]

from .affine import (
    affine_match_tiles,
    affine_solve_single,
    affine_stats,
    batched_affine_match,
    find_best_domain_affine,
)
from .dct import (
    correlation_upper_bound,
    dct2_matrix,
    multi_head_embedding,
    multi_head_embedding_batch,
    quick_energy,
    tile_embedding,
    tile_embedding_batch,
    tonal_embedding,
    tonal_embedding_batch,
    transient_embedding,
    transient_embedding_batch,
)
from .domains import (
    apply_symmetry,
    bank_rows_host,
    box_sums,
    build_bank_jax,
    build_domains_host,
    build_domains_np,
    frame_ranges,
    n_domains_for,
)
from .index import MIPSIndex, ann_query, build_ann_index, build_domain_embeddings
from .perceptual import (
    compute_transient_mask,
    get_mel_filterbank,
    mel_filterbank,
    perceptual_error_batch,
    pruned_affine_search,
)
from .search import (
    exact_search_block,
    gain_topk_scan,
    refine_from_lobes,
    pad_candidates,
    range_candidates_from_embedding,
    range_candidates_from_embedding_emb,
    topk_scores_block,
    topk_search_block,
)
from .vad import voiced_detection, voiced_mask_jax

__all__ = [
    "affine_match_tiles", "affine_solve_single", "affine_stats",
    "batched_affine_match", "find_best_domain_affine",
    "correlation_upper_bound", "dct2_matrix", "multi_head_embedding",
    "multi_head_embedding_batch", "quick_energy", "tile_embedding",
    "tile_embedding_batch", "tonal_embedding", "tonal_embedding_batch",
    "transient_embedding", "transient_embedding_batch",
    "apply_symmetry", "bank_rows_host", "box_sums", "build_bank_jax", "build_domains_host",
    "build_domains_np", "frame_ranges", "n_domains_for",
    "MIPSIndex", "ann_query", "build_ann_index", "build_domain_embeddings",
    "compute_transient_mask", "get_mel_filterbank", "mel_filterbank",
    "perceptual_error_batch", "pruned_affine_search",
    "exact_search_block", "gain_topk_scan", "refine_from_lobes",
    "pad_candidates", "range_candidates_from_embedding",
    "range_candidates_from_embedding_emb", "topk_scores_block",
    "topk_search_block",
    "voiced_detection", "voiced_mask_jax",
]

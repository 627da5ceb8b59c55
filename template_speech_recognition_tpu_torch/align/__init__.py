from template_speech_recognition_tpu_torch.align.dtw import (
    banded_dtw,
    dtw_keyword_score,
    dtw_keyword_scores_batch,
    dtw_pairwise_scores,
    dtw_pairwise_scores_from_map,
    frame_llr_matrix,
)

__all__ = [
    "banded_dtw",
    "dtw_keyword_score",
    "dtw_keyword_scores_batch",
    "dtw_pairwise_scores",
    "dtw_pairwise_scores_from_map",
    "frame_llr_matrix",
]

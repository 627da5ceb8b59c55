from template_speech_recognition_tpu_torch.frontend.features import (
    FeatureMap,
    frontend,
    frontend_batch,
    spectrogram,
)
from template_speech_recognition_tpu_torch.frontend.planes import (
    FlatFeatureMap,
    frontend_batch_flat,
)

__all__ = [
    "FeatureMap",
    "FlatFeatureMap",
    "frontend",
    "frontend_batch",
    "frontend_batch_flat",
    "spectrogram",
]

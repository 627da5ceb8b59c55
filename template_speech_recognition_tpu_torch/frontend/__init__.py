from template_speech_recognition_tpu_torch.frontend.planes import (
    FlatFeatureMap,
    frontend_batch_flat,
)

__all__ = ["FlatFeatureMap", "frontend_batch_flat"]

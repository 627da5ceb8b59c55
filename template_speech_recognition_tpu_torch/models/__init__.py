from template_speech_recognition_tpu_torch.models.bank import TemplateBank
from template_speech_recognition_tpu_torch.models.mixture import (
    EMState,
    bernoulli_mixture_em,
    bernoulli_mixture_em_restarts,
    em_step,
)
from template_speech_recognition_tpu_torch.models.template import (
    estimate_background,
    estimate_template,
    register_exemplars,
)

__all__ = [
    "register_exemplars",
    "estimate_template",
    "estimate_background",
    "bernoulli_mixture_em",
    "bernoulli_mixture_em_restarts",
    "em_step",
    "EMState",
    "TemplateBank",
]

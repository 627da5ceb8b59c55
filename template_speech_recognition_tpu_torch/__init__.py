"""PyTorch/CUDA port of the template-based speech recognizer.

The JAX package ``template_speech_recognition_tpu`` is the reference;
this package re-implements its streaming FFT detection scan in PyTorch,
with DTW rescoring of the peaks (config 4) and int8 template spectra
(config 5), every kernel on that path written by hand in CUDA C++ for
Hopper
(``csrc/``, built with ``nvcc`` at first use).  It imports torch and
numpy only -- never jax, never the JAX package.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise.  On the CPU
each kernel wrapper runs its plain PyTorch version (the same function,
used by the tests); on a CUDA tensor it launches the kernel or raises.
"""

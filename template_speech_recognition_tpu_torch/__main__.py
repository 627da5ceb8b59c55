"""``python -m template_speech_recognition_tpu_torch`` dispatches the CLI."""

from template_speech_recognition_tpu_torch.cli import main

if __name__ == "__main__":
    raise SystemExit(main())

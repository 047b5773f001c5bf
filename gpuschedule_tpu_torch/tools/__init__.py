"""Measurement tools run on the card (``python -m gpuschedule_tpu_torch.tools.<name>``)."""

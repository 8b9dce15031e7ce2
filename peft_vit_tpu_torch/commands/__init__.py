"""Command-line drivers (counterpart of ``peft_vit_tpu/commands``)."""

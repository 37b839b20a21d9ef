"""Training: AdamW, the packed LM data pipeline, the chunked checkpoint
store and the train loop (``python -m repro_torch.launch.train``)."""

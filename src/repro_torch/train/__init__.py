"""Training on one device: AdamW and the chunked-CE train step."""

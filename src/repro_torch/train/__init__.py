"""The SplitNN training stage, ported: Eq.(2) losses, Adam, and the
single-device epoch engine (``repro_torch.train.vfl``)."""

"""The serving side, ported: the continuous-batching VFL scoring engine
(``repro_torch.serve.vfl``)."""

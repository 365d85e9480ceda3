"""The serving side, ported: the continuous-batching VFL scoring engine
(``repro_torch.serve.vfl``) and LLM prefill + greedy decode
(``repro_torch.serve.engine``)."""
from repro_torch.serve.engine import (greedy_decode, make_prefill_step,
                                      make_serve_step, serve_context_len)

__all__ = ["greedy_decode", "make_prefill_step", "make_serve_step",
           "serve_context_len"]

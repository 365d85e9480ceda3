"""The LLM substrate, ported: configs' models as params + functions
(``api`` dispatches on the family; ``transformer`` assembles the
decoder-only families from ``attention``, ``ssm``, ``moe`` and
``layers``; ``encdec`` the audio encoder-decoder)."""

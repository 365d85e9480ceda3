"""The LLM substrate, ported: configs' models as params + functions
(``api`` dispatches on the family; ``transformer`` assembles the dense
and ssm decoders from ``attention``, ``ssm`` and ``layers``)."""

"""Plain float32 references of the benchmark's configurations, one module
per configuration (the configuration's name with ``-`` and ``.`` as
``_``), each with ``logits(model, weights, tokens, first, group_len)``."""

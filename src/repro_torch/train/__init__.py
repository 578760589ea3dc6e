"""Single-device training of the port: AdamW, int8 gradient compression,
checkpoints and the loop, the counterparts of ``repro.train``'s
``optimizer``, ``compression``, ``checkpoint`` and ``loop``. State trees
are dicts, lists and tuples of tensors, or ``nn.Module``s (a module is
the dict of its parameters under their dotted names; ``tree.py``)."""

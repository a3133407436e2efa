"""Checkpoint interop (the port's own copy of ``h5_convert``) and the
digits quality tools (counterparts of ``scripts/eval_digits_fid.py`` and
``scripts/eval_conditional_fidelity.py``)."""

"""AdamW and int8 gradient compression (ports of ``repro.optim``)."""

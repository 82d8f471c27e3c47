"""Synthetic matrices and the token stream (copies of ``repro.data``)."""

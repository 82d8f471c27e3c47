"""Synthetic matrix generators (copies of ``repro.data``)."""

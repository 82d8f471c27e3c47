"""The ten architectures of ``repro.configs``: one module each, exporting
``CONFIG`` (the published configuration) and ``smoke_config()`` (the same
family at tiny widths); ``registry`` looks them up by id."""

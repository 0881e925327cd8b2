"""Model serving (port of ``repro.serve.engine``)."""

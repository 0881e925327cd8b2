"""Seeded synthetic datasets (copy of ``repro.data.datasets``)."""

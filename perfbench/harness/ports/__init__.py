"""The program's configuration of each architecture: ``<reference>.py``
holds ``model_config(name, conf, run)`` for the configuration files whose
``reference`` names it (:func:`perfbench.harness.bench.architecture`)."""

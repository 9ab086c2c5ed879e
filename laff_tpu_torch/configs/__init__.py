"""Experiment configs.

Each module defines a ``config`` class; experiments subclass
``base_config.config`` and override attributes. ``adjust_parm`` decodes the
underscore-separated sweep strings. Attribute names match ``laff_tpu``'s
configs (and the reference's), which checkpoints and sweeps address.
"""

from mfgp_jax.fields.wrbf import (  # noqa: F401
    WRBFField, random_field, write_field_settings, parse_field_settings,
)

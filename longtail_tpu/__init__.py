"""The package's former name, kept so that existing imports and
``python -m <this name>.cli`` reach ``longtail_jax`` (utils/alias.py)."""

from longtail_jax.utils.alias import install

install(__name__)

from .tables import TABLES, new_cdf_context, CdfContext  # noqa: F401

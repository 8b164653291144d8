"""The C inference API: ``pd_inference.h`` / ``pd_inference.c`` (the
shim over ``capi_bridge``), ``capi_demo.c`` and ``build.py``."""

"""Generator backends, one per family, all holding the protocol of
``backends.base`` (port of ``hyperscalees_t2i_tpu/backends``).

:data:`BACKEND_MODULES` names each backend's module by its CLI name (the
train CLI's ``--backend`` choices).
"""

BACKEND_MODULES = {
    "sana_one_step": "sana_backend",
    "sana_pipeline": "sana_backend",
    "var": "var_backend",
    "zimage": "zimage_backend",
    "infinity": "infinity_backend",
}

from .modulator import (Modulator, clear_modulator_cache,  # noqa: F401
                        get_modulator, load_dpd_file, load_fir_taps,
                        make_default_layout, resolve_device,
                        state_from_numpy)

from .config import (
    get_log_name_config,
    load_config,
    save_config,
    update_config,
    voi_from_config,
)

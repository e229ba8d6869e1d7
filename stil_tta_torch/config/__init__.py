from stil_tta_torch.config.loader import Config, load_config, parse_overrides

from .misc import (ROOT_PATH, AverageMeter, Progress, check_to_skip, get_logger, makedirs,
                   makedirs_for_file)

__all__ = ["ROOT_PATH", "AverageMeter", "Progress", "check_to_skip", "get_logger", "makedirs",
           "makedirs_for_file"]

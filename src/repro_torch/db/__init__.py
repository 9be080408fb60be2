"""Database facade: ``SearchConfig`` and ``TimeSeriesDB``."""
from repro_torch.db.config import SearchConfig
from repro_torch.db.database import TimeSeriesDB

__all__ = ["SearchConfig", "TimeSeriesDB"]

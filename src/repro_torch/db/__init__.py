"""Database facade: ``SearchConfig``, ``BatchPolicy``, ``TimeSeriesDB``,
the searcher registry and persistence."""
from repro_torch.db.config import BatchPolicy, SearchConfig
from repro_torch.db.database import TimeSeriesDB
from repro_torch.db.persistence import (is_database_dir, load_database,
                                        save_database)
from repro_torch.db.registry import (available_searchers, make_searcher,
                                     register_searcher)

__all__ = ["BatchPolicy", "SearchConfig", "TimeSeriesDB",
           "available_searchers", "is_database_dir", "load_database",
           "make_searcher", "register_searcher", "save_database"]

from ics_tpu_torch.db.engine import Database, IntegrityError, Session, get_database  # noqa: F401
from ics_tpu_torch.db.orm import Model, and_, or_  # noqa: F401

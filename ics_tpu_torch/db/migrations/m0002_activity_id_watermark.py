"""Add sync_status.last_activity_id.

NextCloud's Activity API ``since`` parameter is the last-seen ACTIVITY ID,
not a unix timestamp — the reference passed timestamps, so its incremental
channel silently returned nothing after the first watermark (review
finding; reference defect class SURVEY §2.4). The ID watermark fixes the
semantics; the timestamp columns remain for freshness display.
"""

revision = "0002_activity_id_watermark"
down_revision = "0001_initial_schema"


def upgrade(session) -> None:
    from ics_tpu_torch.db.introspect import column_names

    if "last_activity_id" not in column_names(session, "sync_status"):
        session.execute(
            "ALTER TABLE sync_status ADD COLUMN last_activity_id INTEGER"
        )


def downgrade(session) -> None:
    """Drop the ID watermark; other sync_status columns/rows are preserved
    (matches the reference's column-dropping downgrade shape,
    ``alembic/versions/a3f2b1c4d5e6_add_sync_status_columns.py:44``).
    Both dialects support DROP COLUMN (sqlite >= 3.35; PG always)."""
    session.execute("ALTER TABLE sync_status DROP COLUMN last_activity_id")

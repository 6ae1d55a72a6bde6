"""Application settings.

Environment-variable surface mirrors the reference
(``reference/app/core/config.py:5-84``): same names, same defaults, so a
``.env`` written for the reference drops in unchanged.  pydantic-settings is
not available in this image, so this module implements its own small
env/.env loader on top of plain pydantic v2.

New ``TPU_*`` group configures the inference tier (mesh shape, batching
deadline, precision) — net-new capability per BASELINE.json's north star.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Any, Optional

from pydantic import BaseModel, field_validator


def _parse_env_file(path: Path) -> dict[str, str]:
    """Parse a minimal ``KEY=VALUE`` .env file (comments + blank lines ok)."""
    out: dict[str, str] = {}
    if not path.is_file():
        return out
    for raw in path.read_text().splitlines():
        line = raw.strip()
        if not line or line.startswith("#") or "=" not in line:
            continue
        key, _, value = line.partition("=")
        value = value.strip()
        if len(value) >= 2 and value[0] == value[-1] and value[0] in "\"'":
            value = value[1:-1]
        out[key.strip()] = value
    return out


class Settings(BaseModel):
    """Global settings, loaded from process env and an optional ``.env``.

    Field names are case-sensitive and match the reference's env contract.
    """

    # Environment
    ENV: str = "development"  # "development" | "production" | "test"

    # Database (DSN; sqlite:///path, sqlite:///:memory: or postgresql://...)
    DATABASE_URL: str = "sqlite:///./image_classification.db"

    # API
    API_HOST: str = "0.0.0.0"
    API_PORT: int = 8000

    # From-scratch HTTP server connection hygiene (uvicorn gives the
    # reference timeout_keep_alive=5 free; these are the equivalents).
    # IDLE: reap a socket with no request bytes after this many seconds;
    # HEADER: slow-trickling headers past this -> 408; BODY: total budget
    # for reading a request body; MAX_CONNECTIONS: 503 beyond this.
    SERVER_IDLE_TIMEOUT_S: float = 5.0
    SERVER_HEADER_TIMEOUT_S: float = 10.0
    SERVER_BODY_TIMEOUT_S: float = 60.0
    SERVER_MAX_CONNECTIONS: int = 1024

    # CORS origins, comma-separated
    CORS_ORIGINS: str = "http://localhost:5173,http://127.0.0.1:5173"

    # File constraints (env override accepts ".jpg,.png" or a JSON list —
    # a bare `list` field made any string override crash the app at
    # import with a pydantic ValidationError; self-review r3)
    ALLOWED_EXTENSIONS: list = [".jpg", ".jpeg", ".png", ".gif", ".bmp", ".tiff"]
    MAX_FILE_SIZE: int = 10 * 1024 * 1024

    # Initial admin seed
    ADMIN_NOME_COMPLETO: str = "Administrador do Sistema"
    ADMIN_EMAIL: str = "admin@seudominio.com"
    ADMIN_SENHA: str = "senha_super_secreta"
    ADMIN_CPF: str = "00000000000"

    # JWT
    JWT_SECRET_KEY: str = "dev-secret-key-change-me"
    JWT_ALGORITHM: str = "HS256"
    JWT_ACCESS_TOKEN_EXPIRE_MINUTES: int = 60

    # Login rate limiting (net-new, OPT-IN: the reference has none, so
    # the default 0 preserves contract parity — no surprise 429s).
    # N attempts per identity (email+client IP) per window -> 429;
    # a successful login clears the identity's counter.
    LOGIN_RATE_LIMIT: int = 0            # 0 disables; e.g. 5
    LOGIN_RATE_WINDOW_S: int = 60
    # behind a reverse proxy every request shares the proxy's IP — opt in
    # to keying by X-Forwarded-For instead. A standard appending proxy
    # (nginx proxy_add_x_forwarded_for) APPENDS one hop, so only the
    # LAST N elements are trustworthy: XFF_HOPS is the number of trusted
    # proxies in front; the limiter keys on the element N-from-the-end
    # (the address the innermost trusted proxy saw). First-hop keying
    # would be client-forgeable — an attacker rotates fake first hops for
    # unlimited attempts, or forges a victim's IP to lock them out.
    LOGIN_RATE_TRUST_FORWARDED: bool = False
    LOGIN_RATE_XFF_HOPS: int = 1

    # Cookies
    COOKIE_NAME: str = "access_token"
    COOKIE_HTTPONLY: bool = True
    COOKIE_SAMESITE: str = "lax"
    COOKIE_SECURE: bool = False
    COOKIE_DOMAIN: Optional[str] = None

    # NextCloud WebDAV
    NEXTCLOUD_BASE_URL: str = ""
    NEXTCLOUD_USERNAME: str = ""
    NEXTCLOUD_PASSWORD: str = ""
    NEXTCLOUD_WEBDAV_PATH: str = "/remote.php/dav"
    NEXTCLOUD_USER_PATH: str = ""
    NEXTCLOUD_MAX_PAGE_SIZE: int = 100
    NEXTCLOUD_VERIFY_SSL: bool = True

    # NextCloud sync engine
    NEXTCLOUD_SYNC_ACTIVITY_API_INTERVAL: int = 5      # minutes
    NEXTCLOUD_SYNC_WEBDAV_INTERVAL: int = 300          # minutes
    NEXTCLOUD_SYNC_INITIAL_ON_STARTUP: bool = True
    NEXTCLOUD_SYNC_MAX_RETRIES: int = 3
    NEXTCLOUD_SYNC_RETRY_DELAY: int = 30               # seconds
    NEXTCLOUD_SYNC_BATCH_SIZE: int = 50

    # Timezone
    TIMEZONE: str = "America/Sao_Paulo"

    # ---- TPU inference tier (net-new; BASELINE.json north star) ----
    TPU_ENABLE_INFERENCE: bool = True
    TPU_DEFAULT_MODEL: str = "resnet50"
    # "auto": pure-DP mesh over every visible chip (single-chip -> no mesh);
    # explicit e.g. "8" or "4,2" with TPU_MESH_AXES — serving + training
    # shard the batch over 'data'; 'model' is the TP axis
    TPU_MESH_SHAPE: str = "auto"
    TPU_MESH_AXES: str = "data,model"    # comma-separated axis names
    # multi-host (DCN) initialization — jax.distributed.initialize() runs at
    # inference/train startup when a coordinator address is configured
    # Pipeline parallelism for transformer trunks (ViT family): >= 2
    # builds a ('pp',)-axis serving mesh over that many devices and the
    # engine serves through parallel/pipeline.py (GPipe fill-drain over
    # ICI ppermute). For models whose params/activations exceed one chip.
    # Mutually exclusive with an explicit TPU_MESH_SHAPE (DP via
    # TPU_SERVING_REPLICAS composes with PP; DPxPP in one mesh does not).
    TPU_PP_STAGES: int = 0
    TPU_PP_MICROBATCHES: int = 4
    TPU_COORDINATOR_ADDRESS: str = ""    # "host:port" of process 0
    TPU_NUM_PROCESSES: int = 1
    TPU_PROCESS_ID: int = 0
    TPU_BATCH_BUCKETS: str = "1,8,32,128"  # padded batch buckets
    TPU_BATCH_DEADLINE_US: int = 2000    # dynamic batcher flush deadline
    # adaptive coalescing cap: with requests still in host decode, the
    # flusher may hold the batch open up to this long (see batcher.py)
    TPU_BATCH_MAX_DEADLINE_US: int = 50000
    # two-deep pipelined flush: stage + H2D of batch N+1 under device
    # compute of batch N (batcher.py; measured keep-or-reject in
    # docs/benchmarks.md). Parked batches resolve the moment the queue
    # runs dry, so sparse-traffic latency is unchanged.
    TPU_PIPELINED_FLUSH: bool = True
    TPU_WARMUP_ON_STARTUP: bool = True   # pre-compile batch buckets at boot
    # persistent XLA compilation cache of the JAX package. The port runs
    # eagerly and leaves this one setting unread; it reads every mesh,
    # training and coordinator setting. The name stays because one .env
    # serves both packages. Empty string disables.
    TPU_COMPILATION_CACHE_DIR: str = "/tmp/ics_tpu_xla_cache"
    TPU_DEVICE_DECODE: bool = True       # JPEG decode-on-TPU fast lane
    # restart-marker parallel entropy decode (native/jpeg_mt.cpp): >=2
    # splits eligible JPEG scans at RSTn markers across this many threads;
    # 0/1 = serial libjpeg. Worth cores on real serving hosts — host
    # entropy decode is the binding ingest constraint (docs/benchmarks.md)
    TPU_DECODE_THREADS: int = 0
    TPU_PRECISION: str = "bf16"          # "bf16" | "fp32"
    # ResNet bottleneck chains of stages 0 and 1 through the hand-written
    # fused CUDA kernel (ops/bottleneck.py) instead of cuDNN convs
    TPU_FUSED_CHAINS: bool = False
    TPU_IMAGE_SIZE: int = 224
    TPU_NUM_CLASSES: int = 1000
    TPU_CANVAS: int = 512                # staging canvas side (px)
    TPU_WEIGHTS_DIR: str = "./model_checkpoints"  # fine-tune ckpt root
    # devices for background fine-tune jobs: "" = jit default (single
    # chip), "all" = DP over every chip, "a:b" = slice of jax.devices()
    # DISJOINT from serving's — training never touches serving's chips
    TPU_TRAIN_DEVICES: str = ""
    TPU_CLASSIFY_ON_SYNC: bool = True    # suggest labels for synced images
    # similarity tier: embed newly-synced images inline (off by default —
    # /inferencia/indexar backfills on demand) and the cosine score at or
    # above which a match counts as a near-duplicate
    TPU_EMBED_ON_SYNC: bool = False
    TPU_DUPLICATE_THRESHOLD: float = 0.98
    # replica-level serving + request hedging (SURVEY §5 failure detection):
    # partition the visible chips into N independent engine replicas; a
    # request whose replica hasn't answered within TPU_HEDGE_MS is duplicated
    # onto the next replica and the first result wins. Replicas also bound
    # the blast radius of a wedged device / inline cold compile.
    TPU_SERVING_REPLICAS: int = 1        # 1 = single engine (no hedging)
    TPU_HEDGE_MS: float = 250.0          # straggler hedge timer (ms)

    @field_validator("ALLOWED_EXTENSIONS", mode="before")
    @classmethod
    def _parse_extensions(cls, v):
        if isinstance(v, str):
            v = v.strip()
            if v.startswith("["):
                import json as _json

                return _json.loads(v)
            return [e.strip() for e in v.split(",") if e.strip()]
        return v

    def get_cors_origins_list(self) -> list[str]:
        origins = []
        for raw in self.CORS_ORIGINS.split(","):
            origin = raw.strip()
            if origin.startswith(("http://", "https://")):
                origins.append(origin)
        if origins:
            return origins
        if self.CORS_ORIGINS.strip() and self.CORS_ORIGINS != (
            "http://localhost:5173,http://127.0.0.1:5173"
        ):
            # the operator SET origins but none carried a scheme ('*' or
            # 'app.example.com'): silently substituting the dev localhost
            # list hid the misconfiguration AND served dev CORS headers
            # in production — reject-all and say why (self-review r3)
            import logging

            logging.getLogger(__name__).warning(
                "CORS_ORIGINS sem esquema http(s): %r — nenhuma origem "
                "habilitada (use p.ex. https://app.exemplo.com)",
                self.CORS_ORIGINS,
            )
            return []
        return ["http://localhost:5173", "http://127.0.0.1:5173"]

    def get_mesh_shape(self) -> Optional[tuple[int, ...]]:
        """Explicit mesh shape, or None for "auto" (use every visible chip)."""
        raw = self.TPU_MESH_SHAPE.strip().lower()
        if raw in ("", "auto"):
            return None
        return tuple(int(x) for x in raw.split(",") if x.strip())

    def get_mesh_axes(self) -> tuple[str, ...]:
        return tuple(x.strip() for x in self.TPU_MESH_AXES.split(",") if x.strip())

    def get_batch_buckets(self) -> tuple[int, ...]:
        return tuple(
            sorted(int(x) for x in self.TPU_BATCH_BUCKETS.split(",") if x.strip())
        )

    @classmethod
    def load(cls, env_file: str | os.PathLike = ".env", **overrides: Any) -> "Settings":
        """Build settings: defaults < .env file < process env < overrides."""
        raw: dict[str, Any] = {}
        raw.update(_parse_env_file(Path(env_file)))
        for name in cls.model_fields:
            if name in os.environ:
                raw[name] = os.environ[name]
        raw.update(overrides)
        known = {k: v for k, v in raw.items() if k in cls.model_fields}
        return cls(**known)


settings = Settings.load()


def reload_settings(**overrides: Any) -> Settings:
    """Re-read env (used by tests); mutates the module singleton in place."""
    global settings
    fresh = Settings.load(**overrides)
    settings.__dict__.update(fresh.__dict__)
    return settings

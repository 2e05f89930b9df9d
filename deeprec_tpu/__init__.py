"""deeprec_tpu — a JAX framework for large-scale sparse
recommendation models, built from scratch in JAX/XLA/Pallas with the
capabilities of DeepRec (dynamic hash-keyed embedding tables, feature
admission/eviction, sparse optimizers, incremental checkpointing, sharded
all-to-all embedding exchange, and a CTR model zoo)."""

from . import config
from .config import (CBFFilter, CounterFilter, EmbeddingVariableConfig,
                     GlobalStepEvict, Initializer, L2WeightEvict,
                     StorageOption, StorageType)
from .sparse import embedding_var, hashtable, keys
from .host_index import HostIndexEmbeddingCollection
from .parallel.host_sharded import HostShardedCollection
from .api import (categorical_column_with_adaptive_embedding,
                  categorical_column_with_embedding,
                  categorical_column_with_hash_bucket, embedding_column,
                  get_dynamic_dimension_embedding_variable,
                  get_embedding_variable, get_hash_table,
                  get_multihash_variable, shared_embedding_columns)

__version__ = "0.1.0"

# KV cache page size in tokens (the EXL3 reference format's page size)
PAGE_SIZE = 256

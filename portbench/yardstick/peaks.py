"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense, no
sparsity), at the full 700 W power limit. A card set below it runs slower:
every result line carries the card's power limit beside these."""

BF16_FLOPS = 989e12      # tensor cores, bf16 and fp16
HBM_BYTES = 3.35e12      # bytes a second

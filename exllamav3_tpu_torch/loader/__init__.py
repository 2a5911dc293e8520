from .safetensors import SafetensorsCollection, save_file, f32_to_bf16_u16

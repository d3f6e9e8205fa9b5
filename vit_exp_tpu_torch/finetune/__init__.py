"""Fine-tuning after pretraining: the linear probe on frozen image latents
(lipro) and end-to-end prompt-pair fine-tuning (vocabfine)."""
